#!/usr/bin/env python3
"""The sharded PDLP step's cost by mesh layout, on the card.

    python scripts/torch_mesh_steps.py                      # staircase-64k
    python scripts/torch_mesh_steps.py --n 8192 --device cpu   # a rehearsal

Builds generate_lp(n, n, 8, seed=123, band=256) in float64 on the
block-band operator and times one PDLP major (after a warm one) per
layout: unsharded; 1, 2 and 4 shards on the first device; one shard per
card when there are several; and 4 shards on the first device again at
each interpreter switch interval of --switch-intervals. Each major is
make_major_fn's step driver: CUDA-graph replays unsharded on a card,
eager slots on every shard. Prints, per
layout, the wall and CUDA-event milliseconds per step and the major's
collectives and bytes read across shards, beside each card's name and
power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

ROOT = __file__.rsplit("/scripts/", 1)[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=65_536)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--switch-intervals", default="1e-4,2e-5")
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from cuopt_torch.lp import pdlp
    from cuopt_torch.lp.settings import PDLPSolverSettings
    from cuopt_torch.parallel import make_mesh, shard_problem_and_state
    from cuopt_torch.problem.synthetic import generate_lp

    cuda = a.device.startswith("cuda")
    if cuda:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, check=True)
        print(smi.stdout.strip(), flush=True)
    home = torch.device(a.device if not cuda else "cuda:0")
    prob = generate_lp(a.n, a.n, 8, seed=123, band=256)
    solver = pdlp.PdlpSolver(prob, PDLPSolverSettings(), home)
    dev = pdlp.build_device_problem(prob, solver.hp, torch.float64,
                                    "blockband", home)
    st0 = pdlp.initial_state(dev, solver.hp, torch.float64)
    major = pdlp.make_major_fn(solver.cfg)
    steps = solver.hp.major_iteration

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def timed(label, mesh):
        d, st = (dev, st0) if mesh is None else \
            shard_problem_and_state(dev, st0, mesh)
        st, _ = major(d, st)  # warm
        sync()
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        t0 = time.perf_counter()
        st, rep = major(d, st)
        if cuda:
            e1.record()
        sync()
        wall = 1e3 * (time.perf_counter() - t0) / steps
        ev = e0.elapsed_time(e1) / steps if cuda else float("nan")
        print(f"{label}: {wall:.3f} ms wall, {ev:.3f} ms CUDA events per "
              f"step; {rep.get('collectives', 0)} collectives, "
              f"{rep.get('bytes_sent', 0)} bytes a major", flush=True)

    timed("unsharded", None)
    for k in (1, 2, 4):
        timed(f"{k} shard{'s' if k > 1 else ''} on 1 device",
              make_mesh(devices=[home] * k))
    if cuda and torch.cuda.device_count() > 1:
        timed(f"{torch.cuda.device_count()} shards, one per card",
              make_mesh())
    default = sys.getswitchinterval()
    try:
        for iv in (float(v) for v in a.switch_intervals.split(",") if v):
            sys.setswitchinterval(iv)
            timed(f"4 shards on 1 device, switch interval {iv:g} s",
                  make_mesh(devices=[home] * 4))
    finally:
        sys.setswitchinterval(default)
    return 0


if __name__ == "__main__":
    sys.exit(main())
