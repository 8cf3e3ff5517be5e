#!/usr/bin/env python3
"""Steps of a warm re-solve against a cold one, after a small objective change.

    python scripts/torch_warm_start_steps.py                 # 50k, seeds 0-8
    python scripts/torch_warm_start_steps.py --n 20000 --seeds 0 5 --trace

The re-solve of chip_smoke.py's warm-start phase, with cuopt_torch on the
CPU (float32, block-band operator, the fused row pass's plain version):
solve generate_lp(n, n, 8, seed=123, band=256) by PDLP, capture its
warm-start data, scale the objective by 1 + 1e-3, and re-solve from that
data and cold. Seed 0 starts the first solve from zero; seed k > 0 from
seeded uniform noise in [0, 1e-3), so that the captured state differs.
Prints, per seed, the first solve's steps, the restored restart
bookkeeping, the warm re-solve's new steps and the cold re-solve's steps;
with --trace, also each major of the warm re-solve: its steps, whether it
restarted, its KKT score and the steps since the last restart.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(9)))
    ap.add_argument("--trace", action="store_true")
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import cuopt_torch.lp.pdlp as T
    from cuopt_torch import constants as C
    from cuopt_torch.lp.settings import PDLPSolverSettings
    from cuopt_torch.problem.synthetic import generate_lp

    torch.set_num_threads(2)
    prob = generate_lp(a.n, a.n, 8, seed=123, band=256)
    moved = dataclasses.replace(
        prob, objective_coefficients=prob.objective_coefficients * 1.001)

    def solve(p, trace=False, **kw):
        s = PDLPSolverSettings()
        s.log_to_console = False
        s.dtype = "float32"
        s.method = C.CUOPT_METHOD_PDLP
        s.operator_kind = "blockband"
        for k, v in kw.items():
            setattr(s, k, v)
        solver = T.PdlpSolver(p, s, "cpu")
        solver.cfg = dataclasses.replace(solver.cfg, fused_kernel="on")
        if not trace:
            return solver.run()
        real = T.make_major_fn

        class Traced(T.PingPongMajor):
            def __call__(self, dev, state):
                state, rep = super().__call__(dev, state)
                print(f"    {int(rep['total_steps'])} steps, restart "
                      f"{bool(rep['did_restart'])}, kkt "
                      f"{float(rep['kkt_cur']):.3e}, since restart "
                      f"{int(state.iters_since_restart)}", flush=True)
                return state, rep

        T.make_major_fn = Traced
        try:
            return solver.run()
        finally:
            T.make_major_fn = real

    for seed in a.seeds:
        x0 = None if seed == 0 else \
            np.random.default_rng(seed).uniform(0.0, 1e-3, a.n)
        first = solve(prob, initial_primal_solution=x0)
        ws = first["warm_start_data_fn"]()
        print(f"seed {seed}: first solve {first['iterations']} steps; "
              f"restored last_restart_kkt {ws.last_restart_kkt_score:.3e}, "
              f"{ws.iterations_since_last_restart} steps since its last "
              "restart", flush=True)
        warm = solve(moved, trace=a.trace, warm_start_data=ws)
        cold = solve(moved)
        rel = abs(warm["primal_objective"] - cold["primal_objective"]) / \
            abs(cold["primal_objective"])
        print(f"seed {seed}: warm {warm['iterations'] - ws.total_pdlp_iterations}"
              f" new steps ({warm['status']}), cold {cold['iterations']} "
              f"steps ({cold['status']}), objectives within {rel:.2e}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
