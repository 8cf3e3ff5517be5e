#!/usr/bin/env python3
"""How often the shared C++ crossover crashes, by PDLP tolerance.

    python scripts/torch_crossover_crashes.py            # 10 points per tolerance
    python scripts/torch_crossover_crashes.py --tols 1e-4 --samples 20

For each tolerance, cuopt_torch solves generate_lp(n, n, 8, seed=123,
band=256) by PDLP in float32 on the block-band operator, on the CPU, from
`--samples` starting points (seeded uniform noise in [0, 1e-3) as the
initial primal solution, so that each run converges to another point of
the tolerance ball), then crosses over to a vertex with the native dual
simplex. Each sample runs in a process of its own, because a crash kills
it: the crossover's crash basis can fail to factorize, and then
cpp/dual_simplex/simplex.cpp reads x_B before it exists (Solve :99 ->
Finish :885). Prints one line per sample and a count per tolerance.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(n: int, tol: float, seed: int) -> None:
    import numpy as np
    import torch

    from cuopt_torch import constants as C
    from cuopt_torch.lp.settings import PDLPSolverSettings
    from cuopt_torch.lp.solve import solve_lp
    from cuopt_torch.problem.synthetic import generate_lp

    torch.set_num_threads(1)
    prob = generate_lp(n, n, 8, seed=123, band=256)
    s = PDLPSolverSettings()
    s.log_to_console = False
    s.dtype = "float32"
    s.method = C.CUOPT_METHOD_PDLP
    s.operator_kind = "blockband"
    s.crossover = True
    s.set_optimality_tolerance(tol)
    s.initial_primal_solution = np.random.default_rng(seed).uniform(
        0.0, 1e-3, n)
    info = solve_lp(prob, s, device="cpu").get_additional_termination_information()
    print(f"{info['solved_by']} {info['iterations']} PDLP steps "
          f"{info.get('crossover_iterations')} crossover pivots")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--tols", type=float, nargs="+",
                    default=[1e-4, 5e-5, 2e-5, 1e-5])
    ap.add_argument("--samples", type=int, default=10)
    ap.add_argument("--one", nargs=2, metavar=("TOL", "SEED"),
                    help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.one:
        one(a.n, float(a.one[0]), int(a.one[1]))
        return 0
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    for tol in a.tols:
        crashed = 0
        for seed in range(1, a.samples + 1):
            r = subprocess.run(
                [sys.executable, __file__, "--n", str(a.n), "--one",
                 str(tol), str(seed)], capture_output=True, text=True,
                env=env, timeout=600)
            if r.returncode == -signal.SIGSEGV:
                crashed += 1
                out = "crashed (SIGSEGV)"
            elif r.returncode != 0:
                out = f"failed, exit {r.returncode}: {r.stderr[-300:]}"
            else:
                out = r.stdout.strip().splitlines()[-1]
            print(f"tol {tol:g} seed {seed}: {out}", flush=True)
        print(f"tol {tol:g}: {crashed} of {a.samples} crossovers crashed",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
