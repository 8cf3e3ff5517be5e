#!/usr/bin/env python3
"""Benchmark: PDHG iterations/second on synthetic sparse LPs, one card.

    python3 bench_torch.py                       # the H100 (default cuda)
    python3 bench_torch.py --repeats 5           # five timed windows
    python3 bench_torch.py --device cpu --n 4096 # the whole script, CPU

cuopt_torch's counterpart of bench.py, with the same instances, majors,
metric and unit. Prints ONE JSON line last:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": {...}}

  1. "staircase": generate_lp(n, n, 8, seed=123, band=256), n = 50,000,
     float32 on operator "auto" (a BlockBandOp): every step attempt runs
     the fused row pass, row_pass_atomic on the card.
  2. "shuffled": the same LP under bench.py's default_rng(7) row and
     column permutation; "auto" recovers the band by reordering.

Each instance is built (build_device_problem, initial_state), run for
WARMUP_MAJORS majors, then timed over BENCH_MAJORS majors of
make_major_fn's step driver, the loop solve_lp runs (CUDA-graph replays
on the card); the window
ends in the report's total_steps readback, which waits for the device.
Build and warm-up times are reported apart from it, and so is the nvcc
build of the kernels at first use (0 when the library was already
built). --repeats N times N windows on the same device problems, the
instances in turns; `value` is the median of the runs' geomeans.

vs_baseline is bench.py's: the geomean of the instances' effective slab
GB/s (row_slabs bytes per step x steps/s) over a measured memory roof.
The roof is a STREAM pair on 308 MB buffers, each one PyTorch call
timed by CUDA events over 40 calls: scale (y = a x, 2 x bytes) and
triad (y = c + a x, 3 x bytes). H100 SXM's 3,350 GB/s data-sheet rate
stands beside it. On the CPU nothing of the roof is measured (null).

The row pass's launches per instance are counted from 0 (reset_counts)
over its majors; on the card an instance whose majors never launched
row_pass_atomic ends the run with exit code 1. Without a card, a run on
cuda exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

N_ROWS = 50_000
NNZ_PER_ROW = 8
BAND = 256
WARMUP_MAJORS = 2
BENCH_MAJORS = 40
METRIC = "pdhg_iters_per_s_synth50k_geomean"
UNIT = "iters/s"
H100_SPEC_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
ROOF_MB = 308
ROOF_ITERS = 40


def static_cfg():
    """(StaticCfg, hyper-parameters) of PDLPSolverSettings() defaults,
    built field by field as bench.py builds them."""
    from cuopt_torch.lp.hyper_params import PRESETS
    from cuopt_torch.lp.pdlp import StaticCfg
    from cuopt_torch.lp.settings import PDLPSolverSettings

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
    )
    return cfg, hp


def staircase(n):
    from cuopt_torch.problem.synthetic import generate_lp

    return generate_lp(n, n, NNZ_PER_ROW, seed=123, band=BAND)


def shuffled(prob):
    """The LP under bench.py's random row and column permutation."""
    from cuopt_torch.sparse.reorder import permute_csr

    n, m = prob.n_constraints, prob.n_variables
    rng = np.random.default_rng(7)
    rp, cp = rng.permutation(n), rng.permutation(m)
    offs, idx, vals = permute_csr(
        np.asarray(prob.offsets), np.asarray(prob.indices),
        np.asarray(prob.values, np.float64), rp, cp, n, m)
    return dataclasses.replace(
        prob, offsets=offs, indices=idx, values=vals,
        constraint_lower_bounds=prob.constraint_lower_bounds[rp],
        constraint_upper_bounds=prob.constraint_upper_bounds[rp],
        objective_coefficients=prob.objective_coefficients[cp],
        variable_lower_bounds=prob.variable_lower_bounds[cp],
        variable_upper_bounds=prob.variable_upper_bounds[cp])


def kernel_launches():
    """Each row-pass kernel's launch count so far."""
    from cuopt_torch.lp import pdhg_fused

    return {k.name: k.launches for k in pdhg_fused.KERNELS}


class Instance:
    """One bench instance on its device: built, warmed up, then timed
    window by window from where the last window left its state.
    `launches` counts the row-pass kernels' launches of its majors."""

    def __init__(self, prob, cfg, hp, device):
        import torch

        from cuopt_torch.lp import pdhg_fused
        from cuopt_torch.lp.pdlp import (
            build_device_problem,
            initial_state,
            make_major_fn,
        )
        from cuopt_torch.sparse import BlockBandOp

        pdhg_fused.reset_counts()
        t0 = time.perf_counter()
        self.dev = build_device_problem(prob, hp, torch.float32, "auto",
                                        device)
        self.state = initial_state(self.dev, hp, torch.float32)
        self.fn = make_major_fn(cfg)
        self.build_s = time.perf_counter() - t0
        if not isinstance(self.dev.op, BlockBandOp):
            raise RuntimeError(
                f"operator 'auto' built a {type(self.dev.op).__name__}, "
                "not the block band whose row pass the bench measures "
                "(n * n <= 2^22 takes the dense operator)")
        self.slab_bytes = int(self.dev.op.row_slabs.numel()) * 4
        t0 = time.perf_counter()
        for _ in range(WARMUP_MAJORS):
            self.state, report = self.fn(self.dev, self.state)
        self.steps = int(report["total_steps"])  # waits for the device
        self.warmup_s = time.perf_counter() - t0
        self.launches = kernel_launches()
        self.runs = []

    def window(self):
        """Time BENCH_MAJORS majors: (steps/s, steps, seconds)."""
        before = kernel_launches()
        t0 = time.perf_counter()
        for _ in range(BENCH_MAJORS):
            self.state, report = self.fn(self.dev, self.state)
        total = int(report["total_steps"])  # waits for the device
        elapsed = time.perf_counter() - t0
        steps, self.steps = total - self.steps, total
        self.runs.append(steps / elapsed)
        for k, n in kernel_launches().items():
            self.launches[k] += n - before[k]
        return steps / elapsed, steps, elapsed


def measured_roof(mb=ROOF_MB, iters=ROOF_ITERS):
    """(roof bytes/s, detail) from a STREAM pair on the card: scale
    y = a x (read x, write y: 2 x bytes) and triad y = c + a x (read c
    and x, write y: 3 x bytes), each one library call, timed by CUDA
    events over `iters` calls after a warm call."""
    import torch

    n = mb * 1000 * 1000 // 4
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(n, device="cuda", generator=gen)
    c = torch.rand(n, device="cuda", generator=gen)
    y = torch.empty_like(x)
    b = n * 4
    a = 1.0000001

    def rate(call, mult):
        call()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            call()
        e1.record()
        e1.synchronize()
        return mult * b / (e0.elapsed_time(e1) / 1e3 / iters)

    scale = rate(lambda: torch.mul(x, a, out=y), 2)
    triad = rate(lambda: torch.add(c, x, alpha=a, out=y), 3)
    del x, c, y
    torch.cuda.empty_cache()
    return max(scale, triad), {
        "stream_scale_gbps": round(scale / 1e9, 1),
        "stream_triad_gbps": round(triad / 1e9, 1),
        "stream_buffer_mb": mb,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N_ROWS,
                    help="rows and columns of the staircase")
    ap.add_argument("--repeats", type=int, default=1,
                    help="timed windows per instance")
    ap.add_argument("--out", default=None,
                    help="also write the JSON line to this file")
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from cuopt_torch.utils.device import describe_device

    card = describe_device(a.device)
    cuda = torch.device(a.device).type == "cuda"
    kernel_build_s = 0.0
    if cuda:
        from cuopt_torch.kernels.build import BUILDER

        print(card["smi"], flush=True)
        # nvcc at first use; a library already built costs nothing here
        kernel_build_s = BUILDER.build("row_pass") or 0.0
        BUILDER.library("row_pass")

    cfg, hp = static_cfg()
    t0 = time.perf_counter()
    stair_prob = staircase(a.n)
    shuf_prob = shuffled(stair_prob)
    generate_s = time.perf_counter() - t0
    names = ("staircase", "shuffled")
    insts = {name: Instance(prob, cfg, hp, a.device)
             for name, prob in zip(names, (stair_prob, shuf_prob))}
    for _ in range(a.repeats):
        for name in names:
            insts[name].window()
    counts = {k: insts[k].launches for k in names}

    geomeans = [math.sqrt(s * u) for s, u in
                zip(insts["staircase"].runs, insts["shuffled"].runs)]
    value = statistics.median(geomeans)
    roof, roof_detail = (measured_roof() if cuda else (None, {}))
    slab = {k: insts[k].slab_bytes for k in names}
    eff = [math.sqrt(s * slab["staircase"] * u * slab["shuffled"])
           for s, u in zip(insts["staircase"].runs, insts["shuffled"].runs)]
    eff_gbps = statistics.median(eff)
    stair = statistics.median(insts["staircase"].runs)
    unstructured = statistics.median(insts["shuffled"].runs)
    detail = {
        "device": card["name"],
        "power_limit": card["power_limit"],
        "n": a.n,
        "staircase_iters_per_s": round(stair, 2),
        "shuffled_unstructured_iters_per_s": round(unstructured, 2),
        "runs": {k: [round(r, 2) for r in insts[k].runs] for k in names},
        "geomean_runs": [round(g, 2) for g in geomeans],
        "slab_bytes_per_iter": slab["staircase"],
        "shuffled_slab_bytes_per_iter": slab["shuffled"],
        "staircase_effective_gbps": round(stair * slab["staircase"] / 1e9,
                                          1),
        "shuffled_effective_gbps": round(
            unstructured * slab["shuffled"] / 1e9, 1),
        "pdhg_effective_gbps_geomean": round(eff_gbps / 1e9, 1),
        "measured_roof_gbps": None if roof is None else round(roof / 1e9, 1),
        **roof_detail,
        "h100_spec_gbps": H100_SPEC_BYTES_PER_S / 1e9,
        "vs_h100_spec": round(eff_gbps / H100_SPEC_BYTES_PER_S, 4),
        "launches": counts,
        "generate_s": round(generate_s, 3),
        "kernel_build_s": round(kernel_build_s, 3),
        "build_s": {k: round(insts[k].build_s, 3) for k in names},
        "warmup_s": {k: round(insts[k].warmup_s, 3) for k in names},
        "majors": {"warmup": WARMUP_MAJORS, "timed": BENCH_MAJORS,
                   "repeats": a.repeats},
        "precision": "float32 row pass and step",
    }
    line = json.dumps({
        "metric": METRIC,
        "value": round(value, 2),
        "unit": UNIT,
        "vs_baseline": None if roof is None else round(eff_gbps / roof, 4),
        "detail": detail,
    })
    missing = [k for k in names if counts[k]["row_pass_atomic"] == 0]
    if cuda and missing:
        print(f"bench_torch: row_pass_atomic was never launched on "
              f"{', '.join(missing)}", file=sys.stderr)
        return 1
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
