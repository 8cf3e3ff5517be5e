#!/usr/bin/env python3
"""Where solve_mip's time goes on a staircase MIP, on one CUDA card.

    python scripts/torch_mip_diagnose.py                 # n = 50,000
    python scripts/torch_mip_diagnose.py --n 20000 --root-limit 40

Runs on chip_smoke.py's staircase_mip(n), in float64, in three parts:

  1. root: the LP relaxation by PDLP alone with solve_mip's root settings
     (optimality 1e-6, infeasibility detection) but a limit of its own.
     Prints the steps, gap and primal residual the solve had reached at
     solve_mip's root budget (0.25 of a 60 s limit) and where it ended.
  2. fj: the FJ climbers started from that point's roundings, as solve_mip
     seeds them, for each --fj-variants pair of weight decay and row margin
     (FjEngine), stepped chunk by chunk until one is feasible or the
     budget is spent. Prints each chunk's wall time, its full rescorings
     and the fewest rows of any climber outside their bounds.
  3. mip: solve_mip with a 60 s limit, as chip_smoke.py's phase 14 runs it.

With --trace FILE, every log line of the three parts (PDLP's per-major
lines, the MIP timeline) goes there with its time and thread. Without a card it
exits 1, unless --device cpu runs parts 1 and 2 on the host.
"""

from __future__ import annotations

import argparse
import importlib.util
import logging
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _major_lines(records, t0):
    """(seconds since t0, steps, gap, |rp|) of PDLP's per-major lines."""
    out = []
    for t, msg in records:
        f = msg.split()
        if len(f) >= 11 and f[0].isdigit() and f[1] == "obj":
            out.append((t - t0, int(f[0]), float(f[6]), float(f[8])))
    return out


def part_root(p, limit, records, device):
    from cuopt_torch import constants as C
    from cuopt_torch.lp.pdlp import PdlpSolver
    from cuopt_torch.lp.settings import PDLPSolverSettings

    s = PDLPSolverSettings()
    s.method = C.CUOPT_METHOD_PDLP
    s.set_optimality_tolerance(1e-6)
    s.detect_infeasibility = True
    s.iteration_limit = 10**7
    s.time_limit = limit
    s.dtype = "float64"
    t0 = time.monotonic()
    raw = PdlpSolver(p, s, device).run()
    wall = time.monotonic() - t0
    majors = _major_lines(records, t0)
    at15 = [m for m in majors if m[0] <= 15.0]
    for label, m in (("at 15 s", at15[-1] if at15 else None),
                     ("at the end", majors[-1] if majors else None)):
        if m is not None:
            print(f"[root] {label}: {m[1]} steps in {m[0]:.2f} s, gap "
                  f"{m[2]:.3e}, |rp| {m[3]:.3e}")
    print(f"[root] status {raw['status']}, {raw['iterations']} steps, "
          f"{wall:.2f} s, objective {raw['primal_objective']:.9f}, dual "
          f"{raw['dual_objective']:.9f}, l2 primal residual "
          f"{raw['l2_primal_residual']:.3e}, l2 dual residual "
          f"{raw['l2_dual_residual']:.3e}", flush=True)
    return raw["primal_solution"]


def part_fj(p, x_relax, budget, device, decay=0.95, margin=0.0):
    from cuopt_torch.mip.feasibility_jump import FjEngine, _shortfall
    from cuopt_torch.mip.rounding import make_roundings

    lv = np.where(np.isfinite(p.variable_lower_bounds),
                  p.variable_lower_bounds, 0.0)
    uv = np.where(np.isfinite(p.variable_upper_bounds),
                  p.variable_upper_bounds, lv + 1.0)
    starts = (make_roundings(p, x_relax, n_random=5)
              + make_roundings(p, (lv + uv) / 2, n_random=5))
    eng = FjEngine(p, starts[:8], device=device, decay=decay,
                   margin=margin)
    viol = (_shortfall(eng.batch.act, eng.p) > 1e-6).sum(1)
    print(f"[fj] decay {decay}, margin {margin}: {eng.batch_size} "
          f"climbers, scoring block {eng.block}, violated rows at the start "
          f"{viol.tolist()}", flush=True)
    t_end = time.monotonic() + budget
    while time.monotonic() < t_end:
        before = eng.stats["full_rescores"]
        t0 = time.perf_counter()
        out = eng.step()  # reads the chunk's result: synchronised
        wall = time.perf_counter() - t0
        viol = (_shortfall(eng.batch.act, eng.p) > 1e-6).sum(1)
        print(f"[fj] chunk {eng.chunks}: {wall:.4f} s, "
              f"{eng.stats['full_rescores'] - before} full rescorings, "
              f"fewest violated rows {int(viol.min())}", flush=True)
        if out is not None:
            print(f"[fj] feasible after {eng.chunks} chunks "
                  f"({eng.chunks * eng.steps_per_chunk} steps, "
                  f"{time.monotonic() - t_end + budget:.2f} s), objective "
                  f"{out[1]:.9f}", flush=True)
            return
    print(f"[fj] none feasible after {eng.chunks} chunks", flush=True)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--root-limit", type=float, default=90.0)
    ap.add_argument("--fj-budget", type=float, default=45.0)
    ap.add_argument("--fj-variants", default="0.95:0,1.0:0.01",
                    help="comma-separated decay:margin pairs, each run "
                    "for --fj-budget seconds (FjEngine's decay, margin)")
    ap.add_argument("--parts", default="root,fj,mip")
    ap.add_argument("--device", default="cuda",
                    help='"cpu" runs parts root and fj on the host')
    ap.add_argument("--trace", default=None,
                    help="file for the timed log lines (none by default)")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from cuopt_torch.utils.logger import get_logger

    smoke = _smoke()
    log = get_logger()
    log.setLevel(logging.DEBUG)
    for h in log.handlers:
        h.setLevel(logging.CRITICAL)  # the console: only the trace below
    if args.trace:
        trace = logging.FileHandler(args.trace, mode="w")
        trace.setFormatter(logging.Formatter(
            "%(relativeCreated)10.0f ms %(threadName)s %(message)s"))
        log.addHandler(trace)
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append((time.monotonic(), record.getMessage()))

    log.addHandler(Keep())
    p, x_hat = smoke.staircase_mip(args.n)
    print(f"staircase-mip-{args.n}: x_hat objective "
          f"{float(p.objective_coefficients @ x_hat):.9f}", flush=True)
    parts = args.parts.split(",")
    x_relax = None
    if "root" in parts:
        x_relax = part_root(p, args.root_limit, records, args.device)
    if "fj" in parts:
        for v in args.fj_variants.split(","):
            decay, margin = map(float, v.split(":"))
            part_fj(p, x_relax if x_relax is not None else x_hat * 0.0,
                    args.fj_budget, args.device, decay, margin)
    if "mip" in parts:
        log.info("---- solve_mip ----")
        smoke.phase_mip(f"staircase-mip-{args.n // 1000}k", p, x_hat, 60.0,
                        {"root_lp": "pdlp", "node_lp": "pdlp"})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # the smoke's SmokeFailure too: print, exit 1
        print(f"torch_mip_diagnose: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        sys.exit(1)
