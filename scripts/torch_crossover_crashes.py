#!/usr/bin/env python3
"""How often crossover from a float32 PDLP point reaches the vertex, by
PDLP tolerance.

    python scripts/torch_crossover_crashes.py            # 10 points per tolerance
    python scripts/torch_crossover_crashes.py --tols 1e-4 --samples 20

For each tolerance, cuopt_torch solves generate_lp(n, n, 8, seed=123,
band=256) by PDLP in float32 on the block-band operator, on the CPU, from
`--samples` starting points (seeded uniform noise in [0, 1e-3) as the
initial primal solution, so that each run converges to another point of
the tolerance ball), then crosses over to a vertex with the native dual
simplex. Each sample runs in a process of its own, because a crash kills
it: the shared source (cpp/dual_simplex/simplex.cpp) reads x_B before it
exists when the crossover's crash basis fails to factorize (Solve :99 ->
Finish :885); the port's copy returns NUMERICAL there, and its rank
repair makes up to 16 attempts where the source makes 8
(kernels/build.py SIMPLEX_PATCHES). Prints one line per
sample (its crossover pivots, or its failure) and, per tolerance, how
many samples reached the vertex, failed (a crossover status or an error
exit), or crashed.
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
    sol = solve_lp(prob, s, device="cpu")
    info = sol.get_additional_termination_information()
    if info.get("solved_by") == "pdlp+crossover":
        print(f"pdlp+crossover {info['iterations']} PDLP steps "
              f"{info['crossover_iterations']} crossover pivots, objective "
              f"{sol.get_primal_objective()!r}")
    else:
        print(f"no vertex: crossover status {info.get('crossover_status')}, "
              f"{info['iterations']} PDLP steps")


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
        vertices = failed = crashed = 0
        for seed in range(1, a.samples + 1):
            r = subprocess.run(
                [sys.executable, __file__, "--n", str(a.n), "--one",
                 str(tol), str(seed)], capture_output=True, text=True,
                env=env, timeout=600)
            if r.returncode < 0:
                crashed += 1
                out = f"crashed ({signal.Signals(-r.returncode).name})"
            elif r.returncode != 0:
                failed += 1
                out = f"failed, exit {r.returncode}: {r.stderr[-300:]}"
            else:
                out = r.stdout.strip().splitlines()[-1]
                if out.startswith("pdlp+crossover "):
                    vertices += 1
                else:
                    failed += 1
            print(f"tol {tol:g} seed {seed}: {out}", flush=True)
        print(f"tol {tol:g}: {vertices} of {a.samples} crossovers reached "
              f"the vertex, {failed} failed, {crashed} crashed",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
