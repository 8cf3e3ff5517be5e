#!/usr/bin/env python3
"""PDLP alone against PDLP racing the host dual simplex, on one CUDA card.

    python scripts/torch_concurrent_race.py              # 5 pairs at 50k
    python scripts/torch_concurrent_race.py --pairs 10 --n 50000

Solves generate_lp(n, n, 8, seed=123, band=256) in float32 with
cuopt_torch, alternating method PDLP (alone) and method Concurrent (raced:
the native dual simplex runs on a host thread until PDLP wins and halts
it), in the order alone, raced, raced, alone, ... After one unmeasured
solve (kernel build, device problem), each run prints the PDLP loop's
steps/s (steps after the first major over the loop's seconds), the wall
time and, for a raced run, the grace waited, the halt latency (halt set to
simplex thread joined) and the simplex's pivots when halted. Ends with the
medians. The PDLP loop is host-bound, so this shows how far a host core
busy with the simplex slows it. Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from cuopt_torch import constants as C
    from cuopt_torch.lp.settings import PDLPSolverSettings
    from cuopt_torch.lp.solve import solve_lp
    from cuopt_torch.problem.synthetic import generate_lp

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--pairs", type=int, default=5)
    a = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    prob = generate_lp(a.n, a.n, 8, seed=123, band=256)

    def run(method):
        s = PDLPSolverSettings()
        s.dtype = "float32"
        s.method = method
        s.log_to_console = False
        t0 = time.perf_counter()
        sol = solve_lp(prob, s)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        info = sol.get_additional_termination_information()
        if sol.get_termination_reason() != "Optimal" or \
                info.get("solved_by", "pdlp") != "pdlp":
            raise SystemExit(f"not a PDLP optimum: {info}")
        return info, wall

    run(C.CUOPT_METHOD_PDLP)
    rates = {"alone": [], "raced": []}
    halts = []
    order = []
    for i in range(a.pairs):
        order += ["alone", "raced"] if i % 2 == 0 else ["raced", "alone"]
    for k, side in enumerate(order):
        info, wall = run(C.CUOPT_METHOD_PDLP if side == "alone"
                         else C.CUOPT_METHOD_CONCURRENT)
        rate = info["loop_steps"] / info["solve_loop_s"]
        rates[side].append(rate)
        line = (f"run {k} {side}: {info['iterations']} steps, loop "
                f"{rate:.1f} steps/s, wall {wall:.3f} s")
        if side == "raced":
            race = info["race"]
            halts.append(race["halt_latency_s"])
            line += (f", grace waited {race['grace_waited_s']:.4f} s, halt "
                     f"latency {race['halt_latency_s']:.4f} s, simplex "
                     f"halted after {race['simplex_iterations']} pivots")
        print(line, flush=True)
    print(f"median loop steps/s: alone {statistics.median(rates['alone']):.1f}"
          f" (min {min(rates['alone']):.1f}, max {max(rates['alone']):.1f}), "
          f"raced {statistics.median(rates['raced']):.1f} (min "
          f"{min(rates['raced']):.1f}, max {max(rates['raced']):.1f}); "
          f"halt latency median {statistics.median(halts):.4f} s, max "
          f"{max(halts):.4f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
