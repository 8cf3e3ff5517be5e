#!/usr/bin/env python3
"""Smoke run of cuopt_torch on one CUDA card: build, check, solve.

    python3 chip_smoke.py    # every phase, one card

Phases (any failure exits non-zero; without a CUDA card nothing runs):
  1. device: the card's name and power limit, torch and CUDA versions,
     the nvcc build of cuopt_torch/csrc beside the g++ build of the host
     dual simplex (cpp/dual_simplex), with ptxas' registers, shared
     memory and spills for each kernel instantiation (the one-pass and
     column-split bodies must not spill);
  2. kernels: every kernel of the fused row pass against its plain
     PyTorch version on the card, in both modes, on the 50k staircase,
     its shuffled copy (reordered, with spill), degen-transport at scale
     100,000 (W=4224) and the 300k staircase; the partials mode must give
     the same bits twice, and its A^T y exactly the bits of its per-tile
     parts summed in the plan's order. Each shape prints the kernel body
     it ran (one-pass up to W_ONE_PASS, column-split up to
     W_COLUMN_SPLIT), its resident blocks per SM and its time as a share
     of the one-read bound. Times are device times: CUDA-event means over
     50 calls captured in a CUDA graph (no host launch cost). Then the
     slot's step kernels (lp/pdhg_step.py) against their plain versions
     from the state after one major of the 50k and 300k staircases in
     float32 (the fused row pass) and the 50k staircase in float64 (the
     unfused band products), each timed alone beside the time of the
     bytes it moves, and a whole slot timed and its device ops counted
     both ways (the torch `_slot`, `kernel_slot`);
  3-5. solve_lp by PDLP alone in float32 on the 50k staircase, its
     shuffled copy and the 300k staircase: OPTIMAL, objective within 1e-3
     relative of scipy's HiGHS, the primal residual rechecked on the host
     in float64, and every step attempt launched through the row-pass
     kernels and the step kernels; then the 50k staircase under the
     float64 defaults, OPTIMAL, every attempt through the unfused path's
     step kernels;
  6. solve_lp in float32 on degen-transport at scale 100,000, which PDLP
     does not solve in reasonable time, to a fixed 400 steps:
     ITERATION_LIMIT, finite iterates, every attempt through the
     column-split body of row_pass_partials;
  7. concurrent (the default method: the host dual simplex races PDLP,
     both legs started at once): PDLP wins the 50k staircase in float32
     through row_pass_atomic and the simplex thread is halted and joined;
     the 2k staircase is won by either leg, to HiGHS's optimum within
     1e-9 (simplex) or 1e-3 (PDLP); the simplex wins the 500 staircase,
     within 1e-9, in at most 0.5 s more than alone; the 50k staircase
     under PDLPSolverSettings() defaults (float64);
  8. crossover: PDLP in float32 on the 2k staircase, then the simplex
     from its point to HiGHS's vertex within 1e-9, in fewer pivots than
     a cold simplex; then from three float32 points at the default 1e-4,
     where the shared simplex source crashes the process on most, the
     port's copy must return (OPTIMAL, crossed over or with the
     simplex's status as crossover_status);
  9. warm start: the 50k staircase re-solved from a first solve's state
     after its objective is scaled by 1 + 1e-3, in fewer steps than a
     cold re-solve, every attempt through row_pass_atomic;
  10. profile: the 50k, the 300k and the degen-transport solves once more,
     to six majors, under torch.profiler, for the device's busy time, its
     idle share, the row pass's share of device time and the kernels that
     take the most device time;
  11. batch LP, float64: eight members of the 50k staircase (bounds moved
     on 1% of the columns, one sparsity pattern) by batch_solve as one
     stacked block-band program: each member OPTIMAL within 1e-6 of the
     objective and 2% of the steps of the same member solved alone; and
     eight of the 1k staircase as one stacked dense program: OPTIMAL
     within the solves' 1e-4. In both, three batched majors from a shared
     state take the same attempts as each member's solo majors, x within
     1e-9; the batch's member-steps/s printed beside the solo rate;
  12. exact MIPs: the knapsack and twelve binaries by solve_mip, OPTIMAL
     at the brute-force optimum, the twelve binaries with at least one
     GMI cut round solved and one cut kept, and the twelve binaries by
     BranchAndBound on PDLP nodes, with at least one frontier of two or
     more nodes stacked into one batched program on the card;
  13-14. solve_mip with its defaults on the mixed staircase MIP: at the
     largest n of 5,000, 4,000 and 3,000 whose root the host simplex
     solves inside its budget (root, cuts and nodes by simplex; 30 s
     limit), and at n = 50,000 (root, LP completions and nodes by PDLP on
     the card; 60 s limit). The 3k solve must find an incumbent; the 50k
     one may end at its limit without one (PERF.md, section 6). An incumbent
     is rechecked on the host in float64 and must not lie below the bound;
     the bound must not pass x_hat's objective either; the tree must take
     a node, the FJ climbers must step on the card with no heuristic
     error, and the wall must stay within the limit + 20 s. One FJ chunk
     at 50k is then timed on its own (wall and CUDA events);
  15. routing-gh200-C1: Solve on synth_gh_instance(200, "C", 1) (GHC_200_1
     of scripts/bks_benchmark.py), 15 s, seed 0: status 0, every customer
     served exactly once, time windows and capacity rechecked on the host
     in float64, cost at most 0.97 x the port's cheapest insertion; cost
     and vehicles beside scripts/bks_synth_baseline.json's 2439.01 and
     21, LS rounds, wall and CUDA-event ms per round, host readbacks per
     round, peak device memory;
  16. routing-4k-RC7: synth_gh_instance(4000, "RC", seed=7) (fleet 409,
     the tiled path): build_problem, build_ls_problem, batched
     construction, then 20 rounds of local search: every order at most
     once, every route feasible on the host, cost below construction's;
     one tile's evaluate_moves_topk on the card against the port on the
     CPU, deltas within rtol 1e-5 / atol 1e-3 and the same moves but for
     ties within 1e-3. The routing phases launch no row-pass kernel and
     load no pandas;
  17. surface: linear_programming.Solve with SolverSettings built by
     set_parameter (PDLP, the tolerances) and float32 on staircase-50k,
     OPTIMAL within 1e-3 of HiGHS with every attempt through
     row_pass_atomic; staircase-50k written as an MPS file (about 400k
     nonzeros), read back by the native parser (timed) and solved by
     `python -m cuopt_torch.cli` at its defaults (Concurrent, float64),
     OPTIMAL within 1e-3, its .sol read back and rechecked on the host;
     twelve-binaries through the CLI (integer markers), OPTIMAL at -82;
     the C ABI library in this process through ctypes: staircase-2k by
     cuOptCreateProblem and the dual simplex within 1e-9 of HiGHS,
     staircase-50k by cuOptReadProblem and PDLP within 1e-3; the C program
     csrc/c_api_check.c as a process (when the Python has a shared
     libpython), with the in-process answer to its LP;
  18. service: `python -m cuopt_torch.server -d 1`, its worker on the
     card (listed by nvidia-smi), waited for on /v2/health/ready (503
     until the worker has passed its health check; the seconds to live
     and to ready printed): staircase-50k's LP as JSON (through
     shared memory) and as msgpack+zlib, OPTIMAL within 1e-3, submit to
     result beside the reported solve time; twelve-binaries at -82 with
     an incumbent; GHC_200_1 for 10 s, every order once, time windows and
     capacity rechecked on the host, cost at most 0.97 x cheapest
     insertion; 410 for an abort, 404 for an unknown id, 415 for pickle;
     an LP through the thin client and one through cuopt_sh; no process
     of the server left after SIGTERM;
  19. multi-device, four shards on the card (and one shard per card where
     there are several), each a thread with its own CUDA stream:
     staircase-64k (512 row tiles, the single-exchange halo path; Hx, Hy
     and ty printed) and staircase-50k (the all-gather path, the halo
     gates' failures printed), two float64 majors sharded against two
     unsharded from one state, x and y within 1e-9, equal steps, kkt
     within 1e-8; the step's wall and CUDA-event ms at 1, 2 and 4 shards
     beside the unsharded step, with one attempt's collectives and bytes;
     staircase-64k in float32 sharded to OPTIMAL, within 5e-4 of the
     unsharded solve (through row_pass_atomic), its residual rechecked on
     the host; phase 11's eight 50k members over the shards, each with
     phase 11's status and attempts and its objective within 1e-6;
     GHC_200_1's construction as 4 islands x 4 members, 5 epochs of 8
     sweep steps, each equal to its one-device simulation, the best
     member served once, feasible on the host and no dearer than the
     construction; hierarchical_psum of 2^20 values on 2 x 2 shards
     within 1e-6 of the flat sum. No sharded run launches a row-pass
     kernel;
  20. parity paths: GHC_200_1 as 100 pickup-delivery pairs (windows [0,
     the depot's close]) solved for 10 s, re-routed at half its largest
     arrival stamp with 10 seeded new pairs (the model's orders exactly
     the unfinished and the new, each dummy pickup pinned to its
     carrier) and solved again for 10 s: status 0, every order once,
     pairs on one vehicle pickup first, pins, time windows, each route's
     demand and the load carried after every stop rechecked on the host
     (the local search's host rechecks of device moves printed, checked
     and passed, and the diversity loop's children), the move scores of its routes on the card equal to the
     CPU's, every pair relocate they allow within the carried load on the
     host; GHC_200_1 weighted [COST, TRAVEL_TIME], its reported
     values within 1e-9 of the host's from its routes; GHC_200_1 with 20
     seeded precedence chains: every link among served orders kept, the
     orders left out exactly those reported (their count printed beside
     the 7 of the run before the repair step, with the diversity loop's
     children); the twelve binaries built
     field by field without names, a column fixed by its bounds, by
     solve_mip at the named problem's optimum. No row-pass launch;
  21. the port's benches, each a process of its own: `python3
     bench_torch.py` (the 50k staircase and its shuffled copy, 2 + 40
     majors each) must exit 0 with the metric
     pdhg_iters_per_s_synth50k_geomean, finite steps/s and
     row_pass_atomic launched on both instances (its line is logged, its
     launches stand in the kernels line as "bench_launches"); and
     `scripts/torch_bks_benchmark.py --instances GHC_200_1 --time-limit
     10` must give status 0 with every order served once and the routes
     kept on the host.

The last two lines are one JSON object with every kernel's launches (as
the kernel counted them on the card), error and times (the row pass's
and the step kernels'), and the contract line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import zlib
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# Objectives of the staircase LPs generate_lp(n, n, 8, seed=123, band=256),
# solved in float64 by scipy.optimize.linprog: method "highs" at n=50,000,
# "highs-ipm" at n=300,000. generate_lp is seeded numpy, so the LPs and
# these values are fixed.
HIGHS_OBJ = {50_000: 3036.72780, 300_000: 18536.15500}
# cuopt_tpu on the same LPs, float32, operator "auto", unfused XLA step,
# on a CPU: (accepted steps, step attempts). The port sums in another
# order, so a gap beyond ~20% is printed as a warning, not a failure.
JAX_STEPS = {50_000: (560, 584), 300_000: (720, 737)}
OBJ_RTOL = 1e-3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
N_TIMED = 50
DEGEN_STEPS = 400  # ten majors of 40 steps
PROFILE_STEPS = 240  # six majors
# PDLP's optimality tolerance before the vertex check of phase_crossover.
# On the CPU, from ten float32 PDLP points of the 2k staircase each
# (different starting points), the shared C++ crossover failed to
# factorize its crash basis within its 8 rank-repair attempts (and
# crashed) on 8 at 1e-4 and on none at 5e-5, 2e-5 or 1e-5, with 84 pivots
# from every 1e-5 point; the port's copy (kernels/build.py SIMPLEX_PATCHES,
# 16 attempts) reaches the vertex from all ten at 1e-4, in 730 to 4,221
# pivots (scripts/torch_crossover_crashes.py).
CROSSOVER_TOL = 1e-5
# LPs of tests/test_torch_simplex_exits.py's seeded generator, feasible
# with a finite optimum, on which the shared simplex source says
# INFEASIBLE (its exits at simplex.cpp:249 and :289 took a ray that holds
# only with free columns parked at 0); the port's copy solves them
EXIT_SEEDS = (549, 1606, 3066, 3192, 4323, 4916)

ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, n: int = N_TIMED, reps: int = 3) -> float:
    """Mean device milliseconds of one fn() call: n calls captured in one
    CUDA graph, so that no host launch cost enters the time, replayed
    `reps` times between CUDA events after a warm replay."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # warm: lazy init and allocator, uncaptured
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / (n * reps)


def bound_ms(n_bytes: float, n_flops: float):
    """Least time the card could take: the larger of bytes over the HBM
    rate and float32 operations over the float32 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# --------------------------------------------------------------- problems
def staircase(n):
    from cuopt_torch.problem.synthetic import generate_lp

    return generate_lp(n, n, 8, seed=123, band=256)


def shuffled(prob):
    """The same LP under the random row and column permutation of
    bench.py's unstructured case."""
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


def band_operator(prob, kind):
    """float32 BlockBandOp of `prob` on the card (the inner operator of a
    reordered one)."""
    import torch

    from cuopt_torch.sparse import build_operator

    op = build_operator(prob.offsets, prob.indices, prob.values,
                        prob.n_constraints, prob.n_variables,
                        dtype=torch.float32, kind=kind, device="cuda")
    return getattr(op, "inner", op)


# ----------------------------------------------------------- phase 1
def phase_device():
    import torch

    from cuopt_torch.kernels.build import BUILDER

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, timeout=60)
    log(f"host compiler: {gxx.stdout.splitlines()[0] if gxx.stdout else '?'}")
    # the CUDA kernels (nvcc) and the host simplex (g++) build side by side
    t0 = time.perf_counter()
    # and so do the MPS parser (g++) and the C ABI with its C caller
    # (gcc; the caller links libpython, which a static Python lacks)
    import sysconfig

    shared = bool(sysconfig.get_config_var("Py_ENABLE_SHARED"))
    with ThreadPoolExecutor(4) as pool:
        builds = {
            "row_pass (nvcc)": pool.submit(BUILDER.build, "row_pass"),
            "pdhg_step (nvcc)": pool.submit(BUILDER.build, "pdhg_step"),
            "simplex (g++)": pool.submit(BUILDER.build_simplex),
            "MPS parser (g++)": pool.submit(BUILDER.build_mps),
            ("C ABI and its C caller (gcc)" if shared else "C ABI (gcc)"):
                pool.submit(BUILDER.build_check if shared
                            else BUILDER.build_capi),
        }
        took = {name: f.result() for name, f in builds.items()}

    log(f"build: {time.perf_counter() - t0:.2f} s wall, " + ", ".join(
        f"{name} {'cached' if s is None else f'{s:.2f} s'}"
        for name, s in took.items()))
    for name, out in BUILDER.log.items():
        if name not in ("row_pass", "pdhg_step"):
            continue
        for fn, r in ptxas_report(out).items():
            log(f"  ptxas {name}: {fn}: {r['registers']} registers, "
                f"{r['smem']} bytes static smem, {r['spill_stores']} / "
                f"{r['spill_loads']} bytes spill stores / loads")
            require(not (("one_pass" in fn or "column_split" in fn)
                         and r["spill_stores"] + r["spill_loads"]),
                    f"{fn} spills registers: its width limit is too wide")


def ptxas_report(out: str) -> dict:
    """{kernel instantiation: registers, static smem and spill bytes} from
    the output of nvcc -Xptxas -v, names demangled where c++filt is on
    PATH."""
    rows, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
            rows.setdefault(fn, dict(registers=0, smem=0, spill_stores=0,
                                     spill_loads=0))
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rows[fn]["spill_stores"] = int(m.group(1))
            rows[fn]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows[fn]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            rows[fn]["smem"] = int(sm.group(1)) if sm else 0
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(rows),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        if len(names) == len(rows):
            rows = dict(zip(names, rows.values()))
    return rows


# ----------------------------------------------------------- phase 2
def _row_pass_cost(op, inputs, mode):
    """(bytes, flops) the row pass must move and do: each input read
    once, each output (ax_new, y_new, A^T y) written once. The partials
    mode's per-tile parts are the kernel's scratch, not an output."""
    n, m = op.shape
    vec_in = sum(v.numel() for v in inputs if v is not None)
    n_bytes = 4 * (op.row_slabs.numel() + op.row_slabs.shape[0] + vec_in
                   + 2 * n + m)
    return n_bytes, 4.0 * op.row_slabs.numel() + 10.0 * n


def phase_kernels(ops):
    """Check and time every kernel on each operator. Returns
    {(op name, kernel name): record}."""
    import torch

    from cuopt_torch.kernels.checks import check_row_pass, row_pass_inputs
    from cuopt_torch.lp import pdhg_fused as pf

    records = {}
    for name, op in ops.items():
        inputs = row_pass_inputs(op, seed=0)
        T, _, W = op.row_slabs.shape
        log(f"[kernels] {name}: {op.n_rows}x{op.n_cols}, slabs "
            f"({T},128,{W}), {op.row_slabs.numel() * 4 / 1e6:.1f} MB, "
            f"spill {op.spill_vals.numel()}, n_cols_pad "
            f"{pf.plan(op).n_cols_pad}")
        # no one PyTorch call computes the fused pass (library_ms is
        # null); the nearest yardstick is torch.bmm for Ax plus torch.bmm
        # for A^T y on the same slabs
        xp = torch.cat([inputs[0], inputs[0].new_zeros(
            pf.plan(op).n_cols_pad - op.n_cols)])
        xw = xp[op.row_win].unsqueeze(2)
        y_pad = torch.zeros(T, 1, 128, device=op.row_slabs.device)
        if name == "staircase-50k":
            log(f"[kernels] note: {op.row_slabs.numel() * 4 / 1e6:.1f} MB "
                "of slabs against a 50 MB L2: part of them stays in L2 "
                "between back-to-back launches, so a share of the HBM "
                "bound above 100% is possible here; the solve loop sees "
                "the same reuse. staircase-300k is the clean bandwidth "
                "reading.")

        def bmm_pair():
            torch.bmm(op.row_slabs, xw)
            torch.bmm(y_pad, op.row_slabs)

        t_bmm = cuda_ms(bmm_pair)
        for mode in ("atomic", "partials"):
            res = check_row_pass(op, mode, inputs)
            det = (f", deterministic {res['deterministic']}, folded "
                   f"exact {res['folded_exact']}") if mode == "partials" \
                else ""
            log(f"[kernels] {name} {mode}: ax err {res['ax_err']:.3g}, "
                f"y err {res['y_err']:.3g}, aty err {res['aty_err']:.3g}, "
                f"dots err {res['interaction_err']:.3g} / "
                f"{res['dy_dot_err']:.3g}{det}")
            require(res["ok"], f"{name} {mode}: kernel disagrees with its "
                               f"plain version: {res}")
            kern = pf.ROW_PASS_ATOMIC if mode == "atomic" \
                else pf.ROW_PASS_PARTIALS
            cfg = pf.kernel_config(W, mode)
            log(f"[kernels] {name} {kern.name}: body {cfg['variant']}, "
                f"{cfg['threads']} threads, {cfg['registers']} registers, "
                f"{cfg['smem_bytes']} bytes smem, {cfg['local_bytes']} "
                f"bytes local, {cfg['blocks_per_sm']} resident blocks/SM")
            require(cfg["variant"] == pf.body_of_width(W),
                    f"{name}: W={W} ran the {cfg['variant']} body")
            ms = cuda_ms(lambda: pf.row_pass_kernel(op, *inputs, mode))
            plain = cuda_ms(lambda: pf.row_pass_reference(op, *inputs,
                                                          mode))
            b_ms, b_by = bound_ms(*_row_pass_cost(op, inputs, mode))
            records[(name, kern.name)] = dict(
                max_abs_err=res["max_abs_err"], ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                bmm_pair_ms=t_bmm, variant=cfg["variant"],
                blocks_per_sm=cfg["blocks_per_sm"],
                share_of_bound=b_ms / ms)
            log(f"[kernels] {name} {kern.name}: {ms:.4f} ms "
                f"({cfg['variant']}), bound {b_ms:.4f} ms ({b_by}), share "
                f"of bound {100 * b_ms / ms:.1f}%, plain {plain:.4f} ms, "
                f"bmm pair {t_bmm:.4f} ms")
    return records


# the step kernels' cases: the staircases in the dtype the benchmark
# solves them in, float32 on the fused row pass, float64 on the unfused
# band products
STEP_CASES = (("staircase-50k", 50_000, "float32"),
              ("staircase-300k", 300_000, "float32"),
              ("staircase-50k-f64", 50_000, "float64"))


def _step_bytes(kernel, n, m, es, fused):
    """Bytes a step kernel reads and writes, each vector once: es a
    float, one a mask entry."""
    if kernel == "pdhg_primal":  # x, aty, c, lv, uv -> x_new; masks
        return 6 * m * es + ((4 * es + 2) * n if fused else 0)
    if kernel == "pdhg_dual":  # ax_new, ax, y, lc0, uc0, masks -> y_new
        return (6 * es + 2) * n
    if kernel == "pdhg_row_sums":  # ax_new, ax, y, y_new
        return 4 * n * es
    # pdhg_commit: 6 vectors read and 4 written a side
    return 10 * (n + m) * es


def _device_ops(fn) -> int:
    """Device ops (kernels, copies and fills) of one eager fn() call."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA for e in prof.events())


def phase_step_kernels(probs):
    """Each case of STEP_CASES from the state after one major: every step
    kernel against its plain version (kernels/checks.py
    check_step_kernels, which must pass), then each kernel of its path
    timed alone (cuda_ms) beside the time of its bytes at the HBM rate,
    and a whole slot both ways. The vectors stay in the 50 MB L2 from one
    timed launch to the next, where in a solve the row pass's slabs go
    through it in between, so a share may pass 100%. Returns {(case,
    kernel name): record}."""
    import torch

    from cuopt_torch.kernels.checks import check_step_kernels
    from cuopt_torch.lp import pdhg_step as ps
    from cuopt_torch.lp import pdlp
    from cuopt_torch.lp.pdhg_fused import spilled_row_pass
    from cuopt_torch.lp.settings import PDLPSolverSettings

    records = {}
    for case, n, dtype in STEP_CASES:
        settings = PDLPSolverSettings()
        settings.dtype = dtype
        solver = pdlp.PdlpSolver(probs[n], settings, "cuda")
        cfg = solver.cfg
        dev = pdlp.build_device_problem(probs[n], solver.hp, solver.dtype,
                                        "auto", "cuda")
        s, _ = pdlp.make_major_fn(cfg)(
            dev, pdlp.initial_state(dev, solver.hp, solver.dtype))
        s = s.replace(**{f.name: getattr(s, f.name).clone()
                         for f in dataclasses.fields(s)})
        fused = pdlp._use_fused(dev, solver.dtype, cfg)
        res = check_step_kernels(dev, s, cfg, fused)
        errs = ", ".join(f"{k[:-4]} {v:.3g}" for k, v in res.items()
                         if k.endswith("_err"))
        log(f"[step] {case}: {type(dev.op).__name__}, "
            f"{'fused row pass' if fused else 'unfused products'}; "
            f"against the plain versions: {errs}; deterministic "
            f"{res['deterministic']}, commit the same {res['commit_same']}")
        require(res["ok"], f"{case}: a step kernel disagrees with its "
                           f"plain version: {res}")

        work = ps.step_work(dev, s, fused)
        dst = s.replace(**{f: torch.empty_like(getattr(s, f))
                           for f in ps.COMMIT_FIELDS})
        pending = torch.zeros_like(s.total_steps)
        dst_pending = torch.empty_like(pending)
        ps.primal(dev, s, work)
        if fused:
            ax_new, y_new, aty_new = spilled_row_pass(
                dev.op, work.x_new, s.ax, s.y, work.lc0m, work.uc0m,
                work.sigma)
        else:
            ax_new = dev.op.matvec(work.x_new)
            y_new = ps.dual(dev, s, ax_new, work)
            aty_new = dev.op.rmatvec(y_new)
        calls = {"pdhg_primal": (ps.primal, ps.primal_reference,
                                 (dev, s, work))}
        if fused:
            calls["pdhg_row_sums"] = (ps.row_sums, ps.row_sums_reference,
                                      (s, ax_new, y_new, work))
        else:
            calls["pdhg_dual"] = (ps.dual, ps.dual_reference,
                                  (dev, s, ax_new, work))
        calls["pdhg_commit"] = (ps.commit, ps.commit_reference, (
            s, pending, cfg, dst, dst_pending, work, ax_new, y_new,
            aty_new))
        rows, cols = dev.op.shape
        es = s.x.element_size()
        for name, (kern, plain, args) in calls.items():
            ms = cuda_ms(lambda: kern(*args))
            plain_ms = cuda_ms(lambda: plain(*args))
            b_ms, b_by = bound_ms(_step_bytes(name, rows, cols, es, fused),
                                  0.0)
            records[(case, name)] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, share_of_bound=b_ms / ms,
                dtype=dtype, fused=fused)
            log(f"[step] {case} {name}: {ms:.5f} ms, bound {b_ms:.5f} ms "
                f"({b_by}), share of bound {100 * b_ms / ms:.1f}%, plain "
                f"{plain_ms:.5f} ms")
        slots = {
            "torch _slot": lambda: pdlp._slot(dev, s, pending, cfg, dst,
                                              dst_pending),
            "kernel_slot": lambda: ps.kernel_slot(dev, s, pending, cfg, dst,
                                                  dst_pending, work),
        }
        slot_ms = {k: cuda_ms(fn, 20) for k, fn in slots.items()}
        slot_ops = {k: _device_ops(fn) for k, fn in slots.items()}
        log(f"[step] {case}: a slot {slot_ms['torch _slot']:.4f} ms in "
            f"{slot_ops['torch _slot']} device ops as the torch _slot, "
            f"{slot_ms['kernel_slot']:.4f} ms in {slot_ops['kernel_slot']} "
            f"through the step kernels")
        del dev, s, dst, work, ax_new, y_new, aty_new, calls, slots
        torch.cuda.empty_cache()
    return records


# -------------------------------------------------------- phases 3-5
def host_primal_residual(prob, x):
    """(||violation of l_c <= A x <= u_c||_2, ||b||_2), in float64 on the
    host, with b the larger finite constraint bound by magnitude as the
    solver takes it for its relative tolerance."""
    rows = np.repeat(np.arange(prob.n_constraints), np.diff(prob.offsets))
    act = np.bincount(rows, weights=prob.values * x[prob.indices],
                      minlength=prob.n_constraints)
    lo, hi = prob.constraint_lower_bounds, prob.constraint_upper_bounds
    viol = (np.where(np.isfinite(lo), np.maximum(lo - act, 0.0), 0.0)
            + np.where(np.isfinite(hi), np.maximum(act - hi, 0.0), 0.0))
    b = np.maximum(np.abs(np.where(np.isfinite(lo), lo, 0.0)),
                   np.abs(np.where(np.isfinite(hi), hi, 0.0)))
    return float(np.linalg.norm(viol)), float(np.linalg.norm(b))


def _settings(iteration_limit, **kw):
    """float32 PDLP alone (the default method, Concurrent, would race a
    host simplex beside it)."""
    from cuopt_torch import constants as C
    from cuopt_torch.lp.settings import PDLPSolverSettings

    s = PDLPSolverSettings()
    s.dtype = "float32"
    s.method = C.CUOPT_METHOD_PDLP
    s.iteration_limit = iteration_limit
    s.log_to_console = False
    for k, v in kw.items():
        setattr(s, k, v)
    return s


def reset_counts():
    """Zero the launch counts of the row pass and of the step kernels."""
    from cuopt_torch.lp import pdhg_fused as pf
    from cuopt_torch.lp import pdhg_step as ps

    pf.reset_counts()
    ps.reset_counts()


def launch_counts():
    """{kernel name: launches since the last reset_counts} of the row
    pass and of the step kernels."""
    from cuopt_torch.lp import pdhg_fused as pf
    from cuopt_torch.lp import pdhg_step as ps

    return {k.name: k.launches for k in (*pf.KERNELS, *ps.KERNELS)}


def _solve(name, prob, s, kernels):
    """solve_lp on the card with the launch counts reset just before it;
    prints its status, steps, loop rate and launches and checks that each
    attempt went through `kernels` (the row-pass kernel the fused step
    takes; none for the unfused step) and never through the plain
    version, and through the step kernels of its path: pdhg_primal,
    pdhg_row_sums (fused) or pdhg_dual (unfused), pdhg_commit, with
    every slot counted in step_kernel_slots. The launches are the
    kernels' own count on the card, so a launch that the solve's CUDA
    graphs replay counts each time it runs. Returns (solution, info,
    launch counts)."""
    import torch

    from cuopt_torch.lp import pdhg_fused as pf
    from cuopt_torch.lp import pdlp
    from cuopt_torch.lp.solve import solve_lp

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    sol = solve_lp(prob, s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    plain = pf.PlainCount.calls
    info = sol.get_additional_termination_information()
    info["wall_s"] = wall
    steps, attempts = info["iterations"], info["attempts"]
    loop_s = info["solve_loop_s"]
    dev = pdlp.cached_device_problem(prob)
    op = dev.op if dev is not None else None
    slab_bytes = op.row_slabs.numel() * op.row_slabs.element_size() \
        if hasattr(op, "row_slabs") else None
    shape = tuple(op.row_slabs.shape) if slab_bytes else None
    log(f"[solve] {name}: {sol.get_termination_reason()}, {steps} steps, "
        f"{attempts} attempts, operator {type(op).__name__} slabs {shape}")
    loop_steps, loop_att = info["loop_steps"], info["loop_attempts"]
    rate = loop_steps / loop_s if loop_s > 0 else float("nan")
    gbps = (loop_att * slab_bytes / loop_s / 1e9
            if slab_bytes and loop_s > 0 else float("nan"))
    log(f"[solve] {name}: build + first major {info['compile_s']:.3f} s, "
        f"solve loop {loop_s:.3f} s ({loop_steps} steps, {loop_att} "
        f"attempts), {rate:.1f} steps/s, slab stream {gbps:.1f} GB/s, "
        f"wall {wall:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    log(f"[solve] {name}: launches {launches}, plain-version calls {plain}")
    require(plain == 0, f"{name}: the plain row pass ran {plain} times")
    fused = bool(kernels)
    step = ("pdhg_primal", "pdhg_row_sums" if fused else "pdhg_dual",
            "pdhg_commit")
    for k in (*kernels, *step):
        require(launches[k] == attempts,
                f"{name}: {k} launched {launches[k]} times for {attempts} "
                f"step attempts")
    off = "pdhg_dual" if fused else "pdhg_row_sums"
    require(launches[off] == 0, f"{name}: {off} launched {launches[off]} "
                                f"times on the {'un' * (not fused)}fused step")
    require(info["step_kernel_slots"] == info["graph_slots"] == attempts,
            f"{name}: {info['step_kernel_slots']} step-kernel slots of "
            f"{info['graph_slots']} for {attempts} attempts")
    return sol, info, launches


def phase_solve(name, prob, n, kernels):
    """A staircase solved to optimality: checks status, objective and the
    host residual besides what `_solve` checks. Returns the kernels'
    launch counts of this solve and its termination information."""
    s = _settings(20000)
    sol, info, launches = _solve(name, prob, s, kernels)
    status = sol.get_termination_reason()
    obj = sol.get_primal_objective()
    rel = abs(obj - HIGHS_OBJ[n]) / abs(HIGHS_OBJ[n])
    steps, attempts = info["iterations"], info["attempts"]
    log(f"[solve] {name}: objective {obj:.6f} (HiGHS {HIGHS_OBJ[n]:.5f}, "
        f"rel err {rel:.2e})")
    want_steps, want_att = JAX_STEPS[n]
    if abs(steps - want_steps) > 0.2 * want_steps or \
            abs(attempts - want_att) > 0.2 * want_att:
        log(f"WARNING: {name}: {steps} steps / {attempts} attempts differ "
            f"by more than 20% from cuopt_tpu's {want_steps} / {want_att}")
    require(status == "Optimal", f"{name}: status {status}")
    require(rel <= OBJ_RTOL, f"{name}: objective {obj} vs HiGHS "
                             f"{HIGHS_OBJ[n]} (rel {rel:.2e})")
    res, b_norm = host_primal_residual(prob, sol.get_primal_solution())
    t = s.tolerances
    limit = t.absolute_primal_tolerance + t.relative_primal_tolerance * b_norm
    log(f"[solve] {name}: host float64 primal residual {res:.4e} "
        f"(limit {limit:.4e})")
    require(res <= limit, f"{name}: primal residual {res} > {limit}")
    return launches, info


def phase_f64_solve(p50):
    """The 50k staircase under the float64 defaults, PDLP alone: the
    unfused band products and the unfused path's step kernels for every
    attempt (`_solve`), OPTIMAL within OBJ_RTOL of HiGHS. Returns the
    kernels' launch counts."""
    name = "staircase-50k float64"
    # a copy: a device problem cached apart from the float32 one
    sol, info, launches = _solve(name, dataclasses.replace(p50),
                                 _f64_settings(), ())
    obj = sol.get_primal_objective()
    rel = abs(obj - HIGHS_OBJ[50_000]) / abs(HIGHS_OBJ[50_000])
    log(f"[solve] {name}: objective {obj:.6f} (rel err {rel:.2e})")
    require(sol.get_termination_reason() == "Optimal", f"{name}: status "
            f"{sol.get_termination_reason()}")
    require(rel <= OBJ_RTOL, f"{name}: objective {obj}")
    return launches


# ------------------------------------------------------------ phase 6
def degen_transport():
    from cuopt_torch.problem.mittelmann import GENERATORS

    return GENERATORS["degen-transport"](100_000, 0)


def phase_degen_solve(prob):
    """degen-transport-100k to DEGEN_STEPS steps: ITERATION_LIMIT, finite
    iterates, every attempt through row_pass_partials. Returns the
    kernels' launch counts of this solve."""
    from cuopt_torch.lp import pdlp

    sol, info, launches = _solve("degen-transport-100k", prob,
                                 _settings(DEGEN_STEPS),
                                 ("row_pass_partials",))
    # the layout's price: the slabs against a float32 CSR copy (values,
    # int32 column indices and row offsets)
    n_slab = pdlp.cached_device_problem(prob).op.row_slabs.numel()
    csr_bytes = 4 * (2 * prob.nnz + prob.n_constraints + 1)
    log(f"[solve] degen-transport-100k: {prob.nnz} nonzeros in {n_slab} "
        f"slab entries ({100 * prob.nnz / n_slab:.2f}% dense): "
        f"{4 * n_slab / 1e6:.1f} MB of slabs against {csr_bytes / 1e6:.1f} "
        f"MB as float32 CSR ({4 * n_slab / csr_bytes:.1f}x)")
    status = sol.get_termination_reason()
    x, y = sol.get_primal_solution(), sol.get_dual_solution()
    log(f"[solve] degen-transport-100k: primal objective "
        f"{sol.get_primal_objective():.6f}, |x|max "
        f"{np.max(np.abs(x)):.4e}, |y|max {np.max(np.abs(y)):.4e}")
    require(status == "IterationLimit",
            f"degen-transport-100k: status {status}")
    require(info["iterations"] == DEGEN_STEPS,
            f"degen-transport-100k: {info['iterations']} steps")
    require(x.shape == (prob.n_variables,) and y.shape ==
            (prob.n_constraints,), "degen-transport-100k: solution shapes")
    require(bool(np.all(np.isfinite(x)) and np.all(np.isfinite(y))),
            "degen-transport-100k: iterates not finite")
    return launches


# --------------------------------------------------------- phases 7-9
def highs_objective(prob):
    """The optimum of a minimizing LP by scipy's HiGHS, float64 on the
    host."""
    import scipy.sparse as sp
    from scipy.optimize import linprog

    require(not prob.maximize, "highs_objective takes a minimizing LP")
    A = sp.csr_matrix((prob.values, prob.indices, prob.offsets),
                      shape=(prob.n_constraints, prob.n_variables))
    lo, hi = prob.constraint_lower_bounds, prob.constraint_upper_bounds
    fl, fu = np.isfinite(lo), np.isfinite(hi)
    res = linprog(prob.objective_coefficients,
                  A_ub=sp.vstack([A[fu], -A[fl]]),
                  b_ub=np.concatenate([hi[fu], -lo[fl]]),
                  bounds=np.column_stack([prob.variable_lower_bounds,
                                          prob.variable_upper_bounds]),
                  method="highs")
    require(res.status == 0, f"HiGHS failed: {res.message}")
    return float(res.fun) + prob.objective_offset


def _race_line(name, info, wall):
    race = info["race"]
    log(f"[concurrent] {name}: solved by {info['solved_by']}, grace "
        f"{race['grace_s']:.1f} s (waited {race['grace_waited_s']:.4f} s), "
        f"simplex status {race['simplex_status']} after "
        f"{race['simplex_iterations']} pivots, halt latency "
        f"{race['halt_latency_s']:.4f} s, wall {wall:.3f} s")


def _no_simplex_thread_left(name):
    from cuopt_torch.dual_simplex.concurrent import SIMPLEX_THREAD

    left = [t for t in threading.enumerate() if t.name == SIMPLEX_THREAD]
    require(not left, f"{name}: a simplex thread outlived the race")


def phase_concurrent(p50, p2k, highs_2k, alone_rate):
    """The default method, Concurrent: the host dual simplex races PDLP,
    both legs started at once. (a) staircase-50k in float32: PDLP wins
    through row_pass_atomic, the simplex is halted and joined; its loop
    rate beside the PDLP-alone rate of phase 3. (b) the 2k staircase:
    both legs take about 1 s on an H100, and either may win it:
    OPTIMAL, within 1e-9 of HiGHS's optimum if the simplex won, within
    OBJ_RTOL if PDLP did. (b') the 500 staircase, which the simplex wins:
    to HiGHS's optimum within 1e-9, with a wall at most 0.5 s above the
    simplex's alone (PDLP stops before it builds its device problem, or
    right after). (c) staircase-50k under PDLPSolverSettings() defaults
    (float64, the unfused step). Returns the kernels' launch counts over
    the solves."""
    import torch

    from cuopt_torch import constants as C
    from cuopt_torch.lp import pdhg_fused as pf
    from cuopt_torch.lp.settings import PDLPSolverSettings
    from cuopt_torch.lp.solve import solve_lp

    total = Counter()
    name = "concurrent staircase-50k"
    sol, info, launches = _solve(
        name, p50, _settings(20000, method=C.CUOPT_METHOD_CONCURRENT),
        ("row_pass_atomic",))
    total.update(launches)
    _race_line(name, info, info["wall_s"])
    obj = sol.get_primal_objective()
    rel = abs(obj - HIGHS_OBJ[50_000]) / abs(HIGHS_OBJ[50_000])
    rate = info["loop_steps"] / info["solve_loop_s"]
    log(f"[concurrent] {name}: objective {obj:.6f} (rel err {rel:.2e}), "
        f"PDLP loop {rate:.1f} steps/s raced against {alone_rate:.1f} "
        f"alone (phase 3), {info['iterations']} steps")
    require(sol.get_termination_reason() == "Optimal", f"{name}: status")
    require(info["solved_by"] == "pdlp", f"{name}: {info['solved_by']} won")
    require(rel <= OBJ_RTOL, f"{name}: objective {obj}")
    require("pdlp_error" not in info, f"{name}: {info.get('pdlp_error')}")
    require(info["race"]["simplex_status"] ==
            C.CUOPT_TERIMINATION_STATUS_CONCURRENT_LIMIT,
            f"{name}: simplex ended with {info['race']['simplex_status']}")
    _no_simplex_thread_left(name)

    name = "concurrent staircase-2k"
    reset_counts()
    t0 = time.perf_counter()
    sol = solve_lp(p2k, _settings(20000, method=C.CUOPT_METHOD_CONCURRENT))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    info = sol.get_additional_termination_information()
    _race_line(name, info, wall)
    obj = sol.get_primal_objective()
    rel = abs(obj - highs_2k) / abs(highs_2k)
    launches = launch_counts()
    total.update(launches)
    log(f"[concurrent] {name}: objective {obj:.12f} (HiGHS {highs_2k:.12f}, "
        f"rel err {rel:.2e}), launches {launches}")
    require(sol.get_termination_reason() == "Optimal", f"{name}: status")
    require(rel <= (1e-9 if info["solved_by"] == "dual_simplex"
                    else OBJ_RTOL),
            f"{name}: objective {obj} vs HiGHS {highs_2k}")
    _no_simplex_thread_left(name)

    name = "concurrent staircase-500"
    p500 = staircase(500)
    highs_500 = highs_objective(p500)
    walls = {}
    for method in (C.CUOPT_METHOD_DUAL_SIMPLEX, C.CUOPT_METHOD_CONCURRENT):
        t0 = time.perf_counter()
        sol = solve_lp(p500, _settings(20000, method=method))
        torch.cuda.synchronize()
        walls[method] = time.perf_counter() - t0
    info = sol.get_additional_termination_information()
    alone = walls[C.CUOPT_METHOD_DUAL_SIMPLEX]
    _race_line(name, info, walls[C.CUOPT_METHOD_CONCURRENT])
    obj = sol.get_primal_objective()
    rel = abs(obj - highs_500) / abs(highs_500)
    log(f"[concurrent] {name}: objective {obj:.12f} (HiGHS "
        f"{highs_500:.12f}, rel err {rel:.2e}), the simplex alone "
        f"{alone:.3f} s")
    require(sol.get_termination_reason() == "Optimal", f"{name}: status")
    require(info["solved_by"] == "dual_simplex",
            f"{name}: {info['solved_by']} won")
    require(rel <= 1e-9, f"{name}: objective {obj} vs HiGHS {highs_500}")
    require(walls[C.CUOPT_METHOD_CONCURRENT] <= alone + 0.5,
            f"{name}: raced {walls[C.CUOPT_METHOD_CONCURRENT]:.3f} s "
            f"against {alone:.3f} s alone")
    _no_simplex_thread_left(name)

    name = "concurrent staircase-50k float64 defaults"
    s = PDLPSolverSettings()
    s.log_to_console = False
    reset_counts()
    t0 = time.perf_counter()
    sol = solve_lp(dataclasses.replace(p50), s)  # a copy: its own cache
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    info = sol.get_additional_termination_information()
    _race_line(name, info, wall)
    obj = sol.get_primal_objective()
    rel = abs(obj - HIGHS_OBJ[50_000]) / abs(HIGHS_OBJ[50_000])
    launches = launch_counts()
    total.update(launches)
    log(f"[concurrent] {name}: {sol.get_termination_reason()}, "
        f"{info['iterations']} steps, objective {obj:.6f} (rel err "
        f"{rel:.2e}), launches {launches} (float64 takes the unfused step)")
    require(sol.get_termination_reason() == "Optimal", f"{name}: status")
    require(rel <= OBJ_RTOL, f"{name}: objective {obj}")
    _no_simplex_thread_left(name)
    torch.cuda.empty_cache()
    return total


def exit_lp(seed):
    """(the port's problem, HiGHS's objective) of the seed's LP from
    tests/test_torch_simplex_exits.py's generator, with the same order
    of random draws."""
    from numpy import inf

    from cuopt_torch.problem.mittelmann import _problem

    g = np.random.default_rng(seed)
    m = int(g.integers(3, 12))
    n = int(g.integers(m, 3 * m))
    dens = g.uniform(0.2, 0.6)
    M = (g.random((m, n)) < dens) * np.round(g.normal(0, 2, (m, n)))
    k = int(g.integers(0, n // 2 + 1))
    for _ in range(k):
        a, b = g.integers(0, n, 2)
        M[:, b] = M[:, a] * g.choice([1, -1, 2])
    r, cc = np.nonzero(M)
    v = M[r, cc]
    free = g.random(n) < 0.5
    clo = np.where(free, -inf, 0.0)
    cup = np.where(free, inf, g.choice([inf, 5.0], n))
    x0 = np.where(free, g.normal(0, 3, n), g.uniform(0, 2, n))
    ax = M @ x0
    kind = g.integers(0, 3, m)
    lo = np.where(kind == 0, ax,
                  np.where(kind == 1, ax - g.uniform(0, 1, m), -inf))
    up = np.where(kind == 0, ax,
                  np.where(kind == 1, inf, ax + g.uniform(0, 1, m)))
    c = np.round(g.normal(0, 1, n), 2)
    prob = _problem(lo, up, clo, cup, c, r, cc, v)
    return prob, highs_objective(prob)


def phase_crossover(p2k, highs_2k):
    """PDLP in float32 on the block-band operator, then crossover to a
    vertex on the host: HiGHS's optimum within 1e-9, in fewer pivots than
    a cold simplex. Returns the kernels' launch counts.

    PDLP solves to CROSSOVER_TOL for that check. Then three float32
    points at the default 1e-4 (seeded starts 1-3, those of
    scripts/torch_crossover_crashes.py), from most of which the shared
    C++ crossover's rank repair gives up after 8 attempts (and
    simplex.cpp:99 -> :885 then reads x_B before it exists): the port's
    copy of the simplex (kernels/build.py SIMPLEX_PATCHES), with up to 16
    attempts, must reach the vertex from each, within 1e-9 of HiGHS.
    Last, the EXIT_SEEDS LPs through solve_lp with the methods DualSimplex
    and Concurrent: OPTIMAL, within 1e-6 (1 + |HiGHS|) of HiGHS's
    optimum."""
    from cuopt_torch import constants as C
    from cuopt_torch.dual_simplex.bindings import solve_lp_simplex
    from cuopt_torch.lp import pdhg_fused as pf
    from cuopt_torch.lp.settings import PDLPSolverSettings
    from cuopt_torch.lp.solve import solve_lp
    from cuopt_torch.utils.timer import Timer

    name = "crossover staircase-2k"
    s = _settings(20000, operator_kind="blockband", crossover=True)
    s.set_optimality_tolerance(CROSSOVER_TOL)
    sol, info, launches = _solve(name, p2k, s, ("row_pass_atomic",))
    t0 = time.perf_counter()
    cold = solve_lp_simplex(p2k, s, Timer())
    cold_s = time.perf_counter() - t0
    obj = sol.get_primal_objective()
    rel = abs(obj - highs_2k) / abs(highs_2k)
    log(f"[crossover] {name}: {info['solved_by']}, {info['iterations']} PDLP "
        f"steps, {info.get('crossover_iterations')} crossover pivots against "
        f"{cold['iterations']} for a cold simplex ({cold_s:.3f} s), vertex "
        f"objective {obj:.12f} (rel err {rel:.2e}), wall "
        f"{info['wall_s']:.3f} s")
    require(info["solved_by"] == "pdlp+crossover",
            f"{name}: solved by {info['solved_by']}")
    require(rel <= 1e-9, f"{name}: objective {obj} vs HiGHS {highs_2k}")
    require(info["crossover_iterations"] < cold["iterations"],
            f"{name}: crossover took {info['crossover_iterations']} pivots")
    launches = Counter(launches)
    for seed in (1, 2, 3):
        s = _settings(20000, operator_kind="blockband", crossover=True)
        s.initial_primal_solution = np.random.default_rng(seed).uniform(
            0.0, 1e-3, p2k.n_variables)
        sol, info, got = _solve(f"{name} at 1e-4, start {seed}", p2k, s,
                                ("row_pass_atomic",))
        launches.update(got)
        obj = sol.get_primal_objective()
        rel = abs(obj - highs_2k) / abs(highs_2k)
        log(f"[crossover] {name} at 1e-4, start {seed}: "
            f"{sol.get_termination_reason()}, "
            f"{info.get('solved_by', 'pdlp')}, {info['iterations']} PDLP "
            f"steps, {info.get('crossover_iterations')} crossover pivots "
            f"against {cold['iterations']} for a cold simplex, crossover "
            f"status {info.get('crossover_status', 'none')}, objective "
            f"{obj:.12f} (rel err {rel:.2e}), wall {info['wall_s']:.3f} s")
        require(sol.get_termination_reason() == "Optimal",
                f"{name} at 1e-4, start {seed}: status")
        require(info.get("solved_by") == "pdlp+crossover",
                f"{name} at 1e-4, start {seed}: no vertex (crossover "
                f"status {info.get('crossover_status')})")
        require(rel <= 1e-9, f"{name} at 1e-4, start {seed}: objective "
                f"{obj} vs HiGHS {highs_2k}")
    for seed in EXIT_SEEDS:
        prob, want = exit_lp(seed)
        for method in (C.CUOPT_METHOD_DUAL_SIMPLEX,
                       C.CUOPT_METHOD_CONCURRENT):
            s = PDLPSolverSettings()
            s.log_to_console = False
            s.method = method
            reset_counts()
            sol = solve_lp(prob, s)
            launches.update(launch_counts())
            info = sol.get_additional_termination_information()
            obj = sol.get_primal_objective()
            label = f"exit seed {seed}, method {method}"
            log(f"[crossover] {label}: {sol.get_termination_reason()}, "
                f"solved by {info.get('solved_by')}, objective {obj:.12f} "
                f"(HiGHS {want:.12f})")
            require(sol.get_termination_reason() == "Optimal",
                    f"{label}: status {sol.get_termination_reason()}")
            require(abs(obj - want) <= 1e-6 * (1 + abs(want)),
                    f"{label}: objective {obj} vs HiGHS {want}")
            _no_simplex_thread_left(label)
    return dict(launches)


def phase_warm_start(p50):
    """staircase-50k solved cold, its objective scaled by 1 + 1e-3 (the
    scaling depends only on A), then re-solved from the first solve's
    warm-start data and cold: both OPTIMAL within 1e-4 of each other, the
    warm re-solve in fewer new steps, every attempt through
    row_pass_atomic. Returns the kernels' launch counts."""
    import torch

    from cuopt_torch.lp import pdhg_fused as pf
    from cuopt_torch.lp.solve import solve_lp

    total = Counter()
    kernels = ("row_pass_atomic",)
    first, _, launches = _solve("warm start: staircase-50k", p50,
                                _settings(20000), kernels)
    total.update(launches)
    ws = first.get_pdlp_warm_start_data()
    moved = dataclasses.replace(
        p50, objective_coefficients=p50.objective_coefficients * (1 + 1e-3))
    reset_counts()
    t0 = time.perf_counter()
    warm = solve_lp(moved, _settings(20000, warm_start_data=ws))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    total.update(launches)
    info = warm.get_additional_termination_information()
    steps = info["iterations"] - ws.total_pdlp_iterations
    attempts = info["attempts"] - ws.total_pdhg_iterations
    log(f"[warm start] warm re-solve: {warm.get_termination_reason()}, "
        f"{steps} new steps, {attempts} new attempts (counters restored at "
        f"{ws.total_pdlp_iterations} / {ws.total_pdhg_iterations}), wall "
        f"{wall:.3f} s, launches {launches}, plain-version calls "
        f"{pf.PlainCount.calls}")
    require(pf.PlainCount.calls == 0, "warm re-solve: plain row pass ran")
    for k in ("row_pass_atomic", "pdhg_primal", "pdhg_row_sums",
              "pdhg_commit"):
        require(launches[k] == attempts,
                f"warm re-solve: {launches[k]} launches of {k} for "
                f"{attempts} attempts")
    cold, cold_info, launches = _solve("warm start: cold re-solve", moved,
                                       _settings(20000), kernels)
    total.update(launches)
    a, b = warm.get_primal_objective(), cold.get_primal_objective()
    log(f"[warm start] warm {steps} steps against cold "
        f"{cold_info['iterations']}; objectives {a:.6f} / {b:.6f} (rel "
        f"{abs(a - b) / abs(b):.2e})")
    require(warm.get_termination_reason() == "Optimal" and
            cold.get_termination_reason() == "Optimal",
            "warm start: a re-solve is not OPTIMAL")
    require(abs(a - b) <= 1e-4 * abs(b), f"warm start: objectives {a} / {b}")
    require(0 < steps < cold_info["iterations"],
            f"warm start: {steps} warm steps against "
            f"{cold_info['iterations']} cold")
    return total


# ----------------------------------------------------------- phase 10
def phase_profile(name, prob, iteration_limit=20000):
    """Where a float32 solve's time goes: the solve runs once unprofiled
    (device problem cached, kernels built), then again under
    torch.profiler. Prints the unprofiled wall time, the device time
    summed over all kernels, the device's idle share (1 - device time /
    unprofiled wall), the row pass's share of device time and the kernels
    that take most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cuopt_torch.lp.solve import solve_lp

    s = _settings(iteration_limit)
    solve_lp(prob, s)  # builds and caches the device problem
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = solve_lp(prob, s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solve_lp(prob, s)
        torch.cuda.synchronize()
    # kernels only: operator and record_function rows repeat their
    # kernels' device time
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_s = sum(r[1] for r in rows) / 1e6
    pass_s = sum(r[1] for r in rows if "row_pass" in r[0]) / 1e6
    steps = sol.get_nb_iterations()
    log(f"[profile] {name}: {steps} steps, unprofiled solve {wall:.4f} s "
        f"({1e3 * wall / steps:.4f} ms/step, {steps / wall:.1f} steps/s), "
        f"device busy {busy_s:.4f} s ({1e3 * busy_s / steps:.4f} "
        f"ms/step), idle share {1 - busy_s / wall:.3f}, row pass "
        f"{1e3 * pass_s / steps:.4f} ms/step = {100 * pass_s / busy_s:.1f}% "
        f"of device time, {100 * pass_s / wall:.1f}% of wall")
    for key, us, count in rows[:12]:
        log(f"[profile] {name}:   {us / 1e3:9.3f} ms  {count:7d} x  "
            f"{key[:90]}")


# ----------------------------------------------------------- phase 11
BATCH_MEMBERS = 8


def batch_members(base, seed=11):
    """BATCH_MEMBERS copies of `base`, each with lv = 0.1 or uv = 0.9 on a
    seeded 1% of its columns: generate_lp's interior point (in [0.2, 0.8])
    stays feasible, and every member keeps base's sparsity pattern."""
    rng = np.random.default_rng(seed)
    n = base.n_variables
    out = []
    for _ in range(BATCH_MEMBERS):
        lv = base.variable_lower_bounds.copy()
        uv = base.variable_upper_bounds.copy()
        cols = rng.choice(n, n // 100, replace=False)
        low = rng.random(len(cols)) < 0.5
        lv[cols[low]] = 0.1
        uv[cols[~low]] = 0.9
        out.append(dataclasses.replace(base, variable_lower_bounds=lv,
                                       variable_upper_bounds=uv))
    return out


def batch_majors_check(name, members, s, majors=3):
    """The batched major against each member's solo major from the same
    state, `majors` times (each starting from the solo states): the same
    step attempts, and x within 1e-9 relative. Returns the worst gap."""
    from cuopt_torch.lp import batch as TB
    from cuopt_torch.lp import pdlp

    solver = pdlp.PdlpSolver(members[0], s, "cuda")
    cfg = dataclasses.replace(solver.cfg, fused_kernel="off")
    devs = [pdlp.cached_device_problem(m) for m in members]
    states = [pdlp.initial_state(d, solver.hp, solver.dtype) for d in devs]
    fns = TB._batched_fns(cfg, devs[0], states[0])
    solos = [pdlp.make_major_fn(cfg) for _ in members]
    dev_b = TB._stack(devs)
    worst = 0.0
    for k in range(majors):
        st_b, rep = TB._batched_major(fns, dev_b, TB._stack(states), cfg)
        for b in range(len(members)):
            states[b], r = solos[b](devs[b], states[b])
            require(int(r["total_attempts"]) ==
                    int(rep["total_attempts"][b]),
                    f"{name} member {b}: attempts differ in major {k}")
            x = states[b].x
            gap = float((st_b["x"][b] - x).abs().max() / x.abs().max())
            worst = max(worst, gap)
    log(f"[batch] {name}: {majors} majors of every member batched and "
        f"alone from the same states: the same attempts, x within "
        f"{worst:.2e} relative")
    require(worst <= 1e-9, f"{name}: batched x {worst:.2e} from solo")
    return worst


def phase_batch(name, base, kind, obj_rtol=1e-6, steps_rtol=0.02):
    """batch_solve on BATCH_MEMBERS same-pattern members of `base` in
    float64 (PDLPSolverSettings() defaults, PDLP alone): one stacked
    program of operator `kind`. Each member must end OPTIMAL within
    `steps_rtol` of the steps (None: not checked), and within `obj_rtol`
    relative of the objective, of the same member solved alone by
    solve_lp, and its batched majors must follow its solo ones
    (batch_majors_check). Prints the batch's member-steps/s beside the
    solo rate, both over the wall time of the calls."""
    import torch

    from cuopt_torch import batch_solve
    from cuopt_torch import constants as C
    from cuopt_torch.lp import pdlp
    from cuopt_torch.lp.settings import PDLPSolverSettings
    from cuopt_torch.lp.solve import solve_lp

    s = PDLPSolverSettings()
    s.method = C.CUOPT_METHOD_PDLP
    s.log_to_console = False
    members = batch_members(base)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sols = batch_solve(members, s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    op = pdlp.cached_device_problem(members[0]).op
    shape = tuple(getattr(op, "row_slabs", getattr(op, "mat", None)).shape)
    log(f"[batch] {name}: {len(members)} members, stacked {kind} "
        f"({len(members)}, {', '.join(map(str, shape))}), float64, wall "
        f"{wall:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    steps_b = [sol.get_nb_iterations() for sol in sols]
    solo_steps, solo_objs, solo_wall = [], [], 0.0
    for k, (member, sol) in enumerate(zip(members, sols)):
        require(sol.get_additional_termination_information().get(
            "solved_by") == "pdlp_batch", f"{name}: member {k} not batched")
        t0 = time.perf_counter()
        solo = solve_lp(dataclasses.replace(member), s)  # its own cache
        torch.cuda.synchronize()
        solo_wall += time.perf_counter() - t0
        solo_steps.append(solo.get_nb_iterations())
        a, b = sol.get_primal_objective(), solo.get_primal_objective()
        solo_objs.append(b)
        rel = abs(a - b) / abs(b)
        log(f"[batch] {name} member {k}: {sol.get_termination_reason()}, "
            f"{steps_b[k]} steps (alone {solo_steps[k]}), objective "
            f"{a:.9f} (alone {b:.9f}, rel {rel:.2e})")
        require(sol.get_termination_reason() == "Optimal" and
                solo.get_termination_reason() == "Optimal",
                f"{name} member {k}: not OPTIMAL")
        require(rel <= obj_rtol,
                f"{name} member {k}: objective rel {rel:.2e}")
        require(steps_rtol is None or abs(steps_b[k] - solo_steps[k])
                <= steps_rtol * solo_steps[k],
                f"{name} member {k}: {steps_b[k]} steps batched against "
                f"{solo_steps[k]} alone")
    # each member's answer is its own: nearer its solo objective than any
    # other member's
    objs_b = [sol.get_primal_objective() for sol in sols]
    margin = min(
        min(abs(a - solo_objs[j]) for j in range(len(sols)) if j != k)
        / max(abs(a - solo_objs[k]), 1e-300)
        for k, a in enumerate(objs_b))
    log(f"[batch] {name}: every member nearer its own solo objective than "
        f"any other member's, by a factor of at least {margin:.1f}")
    require(margin > 1.0, f"{name}: a member's objective is nearer another "
            f"member's solo objective than its own")
    log(f"[batch] {name}: {sum(steps_b) / wall:.1f} member-steps/s "
        f"batched ({sum(steps_b)} steps in {wall:.3f} s) against "
        f"{sum(solo_steps) / solo_wall:.1f} steps/s alone "
        f"({sum(solo_steps)} steps in {solo_wall:.3f} s), walls with "
        f"problem builds")
    batch_majors_check(name, members, s)
    torch.cuda.empty_cache()
    return sols


# ----------------------------------------------------------- phase 12
def knapsack():
    """max 5x0+4x1+3x2 s.t. 2x0+3x1+x2 <= 5, 4x0+x1+2x2 <= 11, x in
    {0..3}, as a minimization (tests/torch_mip_instances.py)."""
    from cuopt_torch.problem.data_model import OptimizationProblem

    A = np.array([[2.0, 3.0, 1.0], [4.0, 1.0, 2.0]])
    return OptimizationProblem.from_dense(
        A, c=np.array([-5.0, -4.0, -3.0]),
        constraint_lower=np.array([-np.inf, -np.inf]),
        constraint_upper=np.array([5.0, 11.0]),
        variable_lower=np.zeros(3), variable_upper=np.full(3, 3.0),
        variable_types=np.array(["I", "I", "I"]))


def twelve_binaries():
    """Twelve binaries under three knapsack rows
    (tests/torch_mip_instances.py)."""
    from cuopt_torch.problem.data_model import OptimizationProblem

    rng = np.random.default_rng(5)
    A = rng.integers(1, 9, (3, 12)).astype(float)
    return OptimizationProblem.from_dense(
        A, c=-(rng.integers(3, 20, 12).astype(float)),
        constraint_lower=np.full(3, -np.inf),
        constraint_upper=A.sum(axis=1) * 0.4,
        variable_lower=np.zeros(12), variable_upper=np.ones(12),
        variable_types=np.array(["I"] * 12))


def brute_force_min(p):
    """The optimum of a small bounded integer MIP by enumeration."""
    import itertools

    A = p.to_dense()
    best = np.inf
    for x in itertools.product(*[
            range(int(lo), int(hi) + 1) for lo, hi in
            zip(p.variable_lower_bounds, p.variable_upper_bounds)]):
        x = np.asarray(x, float)
        if np.all(A @ x <= p.constraint_upper_bounds + 1e-9) and \
                np.all(A @ x >= p.constraint_lower_bounds - 1e-9):
            best = min(best, float(p.objective_coefficients @ x))
    return best


def _mip_settings(time_limit):
    from cuopt_torch.lp.settings import MIPSolverSettings

    s = MIPSolverSettings()
    s.time_limit = time_limit
    s.log_to_console = False
    return s


def phase_exact_mips():
    """The knapsack and the twelve binaries by solve_mip on the card:
    OPTIMAL at the brute-force optimum. Then the twelve binaries by
    BranchAndBound with PDLP node relaxations (use_simplex=False): the
    tree must stack at least one frontier of two or more nodes into one
    batched program on the card, and reach the same optimum."""
    from cuopt_torch import solve_mip
    from cuopt_torch.lp.settings import MIPSolverSettings
    from cuopt_torch.mip.branch_and_bound import BranchAndBound
    from cuopt_torch.utils.timer import Timer

    for name, p in (("knapsack", knapsack()),
                    ("twelve-binaries", twelve_binaries())):
        t0 = time.perf_counter()
        sol = solve_mip(p, _mip_settings(60.0))
        wall = time.perf_counter() - t0
        best = brute_force_min(p)
        log(f"[mip] {name}: {sol.get_termination_reason()}, objective "
            f"{sol.get_primal_objective()} (brute force {best}), nodes "
            f"{sol._raw['nodes']}, wall {wall:.3f} s")
        require(sol.get_termination_reason() == "Optimal",
                f"{name}: status {sol.get_termination_reason()}")
        require(sol.get_primal_objective() == best, f"{name}: objective")
        require(sol._raw["heuristic_errors"] == [],
                f"{name}: {sol._raw['heuristic_errors']}")
        log(f"[mip] {name}: tree {sol._raw['mip_stats']}")
    # a GMI round that finishes, on cuts valid on the brute-force optimum
    # (the objective check above)
    require(sol._raw["mip_stats"]["cut_rounds_solved"] >= 1 and
            sol._raw["mip_stats"]["root_cuts"] >= 1,
            "twelve-binaries: no finished cut round with a cut")
    p = twelve_binaries()
    bnb = BranchAndBound(p, MIPSolverSettings(), device="cuda")
    bnb.use_simplex = False
    sizes = []
    batch = bnb._solve_relaxations_batch

    def counted(nodes, timer):
        raws = batch(nodes, timer)
        sizes.append(sum(r.get("solved_by") == "pdlp_batch" for r in raws))
        return raws

    bnb._solve_relaxations_batch = counted
    t0 = time.perf_counter()
    res = bnb.solve(Timer(120.0))
    wall = time.perf_counter() - t0
    log(f"[mip] twelve-binaries, PDLP nodes: status {res['status']}, "
        f"incumbent {res['incumbent_obj']}, bound {res['best_bound']:.6f}, "
        f"{res['nodes']} nodes, batched frontiers of {sizes} nodes, wall "
        f"{wall:.3f} s")
    require(res["incumbent_obj"] == brute_force_min(p),
            "twelve-binaries, PDLP nodes: incumbent")
    require(max(sizes, default=0) >= 2,
            "twelve-binaries, PDLP nodes: no batched frontier of 2 or more")


# ------------------------------------------------------- phases 13-14
def staircase_mip(n, seed=0):
    """generate_lp(n, n, 8, seed=123, band=256) with a seeded 30% of its
    columns integer (their bounds are [0, 1]: binary) and row upper bounds
    A x_hat + U(0.1, 1.0) for a point x_hat with binary entries in {0, 1}
    and the others in U(0.2, 0.8): x_hat is feasible by construction and
    the instance mixed. The tests define the same instance
    (tests/torch_mip_instances.py). Returns (problem, x_hat)."""
    p = staircase(n)
    rng = np.random.default_rng(seed)
    is_int = np.zeros(n, bool)
    is_int[rng.choice(n, int(0.3 * n), replace=False)] = True
    x_hat = np.where(is_int, rng.integers(0, 2, n), rng.uniform(0.2, 0.8, n))
    rows = np.repeat(np.arange(n), np.diff(p.offsets))
    act = np.bincount(rows, weights=p.values * x_hat[p.indices], minlength=n)
    ub = act + rng.uniform(0.1, 1.0, n)
    return dataclasses.replace(
        p, variable_types=np.where(is_int, "I", "C").astype("U1"),
        constraint_upper_bounds=ub, rhs=ub.copy()), x_hat


def simplex_root_size(sizes=(5000, 4000, 3000), budget=3.0):
    """The first n of `sizes` whose staircase MIP relaxation the host dual
    simplex solves to OPTIMAL within `budget` seconds: the root budget
    solve_mip gives it under a 30 s limit (0.1 x the time left, at least
    2 s). Prints each try."""
    from cuopt_torch import constants as C
    from cuopt_torch.dual_simplex.bindings import solve_lp_simplex
    from cuopt_torch.lp.settings import PDLPSolverSettings
    from cuopt_torch.utils.timer import Timer

    for n in sizes:
        p, _ = staircase_mip(n)
        s = PDLPSolverSettings()
        s.time_limit = budget
        t0 = time.perf_counter()
        raw = solve_lp_simplex(p, s, Timer())
        took = time.perf_counter() - t0
        ok = raw["status"] == C.CUOPT_TERIMINATION_STATUS_OPTIMAL
        log(f"[mip] root simplex probe, staircase-mip-{n}: status "
            f"{raw['status']}, {raw['iterations']} pivots, {took:.3f} s "
            f"(budget {budget} s)")
        if ok:
            return n
    raise SmokeFailure(f"no staircase MIP of {sizes} has its root simplex "
                       f"inside {budget} s")


def host_mip_check(p, x):
    """(max row violation, max bound violation, integral) of x for p, in
    float64 on the host."""
    rows = np.repeat(np.arange(p.n_constraints), np.diff(p.offsets))
    act = np.bincount(rows, weights=p.values * x[p.indices],
                      minlength=p.n_constraints)
    lo, hi = p.constraint_lower_bounds, p.constraint_upper_bounds
    row = max(float(np.max(np.where(np.isfinite(lo), lo - act, 0.0))),
              float(np.max(np.where(np.isfinite(hi), act - hi, 0.0))), 0.0)
    bnd = max(float(np.max(p.variable_lower_bounds - x)),
              float(np.max(x - p.variable_upper_bounds)), 0.0)
    is_int = p.variable_types == "I"
    return row, bnd, bool(np.all(x[is_int] == np.round(x[is_int])))


def phase_mip(name, p, x_hat, time_limit, want):
    """solve_mip with the defaults (float64) and `time_limit` on the card.
    `want` names the engines the tree must have used (its mip_stats).
    Requires an incumbent (FEASIBLE_FOUND or OPTIMAL), feasible on the
    host in float64 (rows within 1e-6, integral, within bounds) and at or
    above the bound, and a finite bound at or below x_hat's objective
    (x_hat is feasible). At least one node, at least one FJ chunk stepped
    on the card, no heuristic error, and wall <= time_limit + 20 s.
    Returns the solution."""
    import torch

    from cuopt_torch import solve_mip
    from cuopt_torch.lp import pdlp

    runs, lock = Counter(), threading.Lock()
    run = pdlp.PdlpSolver.run

    def counted(self, *a, **k):  # PDLP solves by device, this phase only
        with lock:  # the FJ thread's LP completions count too
            runs[str(self.device)] += 1
        return run(self, *a, **k)

    pdlp.PdlpSolver.run = counted
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        sol = solve_mip(p, _mip_settings(time_limit))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        pdlp.PdlpSolver.run = run
    raw = sol._raw
    x = sol.get_primal_solution()
    obj, bound = sol.get_primal_objective(), sol.get_solution_bound()
    obj_hat = float(p.objective_coefficients @ x_hat)
    fj = raw.get("fj") or {}
    status = sol.get_termination_reason()
    log(f"[mip] {name}: {status}, objective {obj:.9f} (x_hat "
        f"{obj_hat:.9f}), bound {bound:.9f}, gap {raw['mip_gap']:.3e}, "
        f"{raw['nodes']} nodes, wall {wall:.3f} s (limit {time_limit} s)")
    log(f"[mip] {name}: tree {raw.get('mip_stats')}, PDLP solves by device "
        f"{dict(runs)}, FJ {fj}, heuristic errors "
        f"{raw['heuristic_errors']}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    require(status in ("Optimal", "FeasibleFound"),
            f"{name}: status {status}")
    row, bnd, integral = host_mip_check(p, x)
    log(f"[mip] {name}: host float64 recheck: max row violation "
        f"{row:.3e}, max bound violation {bnd:.3e}, integral {integral}")
    require(row <= 1e-6 and bnd <= 1e-9 and integral,
            f"{name}: incumbent infeasible on the host")
    require(bound <= obj + 1e-9 * max(1.0, abs(obj)),
            f"{name}: bound {bound} above objective {obj}")
    require(np.isfinite(bound) and bound <= obj_hat + 1e-9 * abs(obj_hat),
            f"{name}: bound {bound} against x_hat's {obj_hat}")
    require(raw["nodes"] >= 1, f"{name}: no node")
    require(fj.get("chunks", 0) >= 1 and
            str(fj.get("device", "")).startswith("cuda"),
            f"{name}: FJ did not step on the card: {fj}")
    require(raw["heuristic_errors"] == [],
            f"{name}: {raw['heuristic_errors']}")
    require(wall <= time_limit + 20.0, f"{name}: wall {wall:.1f} s")
    for k, v in want.items():
        require(raw["mip_stats"][k] == v,
                f"{name}: {k} {raw['mip_stats'][k]}, want {v}")
    on_card = sum(v for k, v in runs.items() if k.startswith("cuda"))
    if want.get("node_lp") == "pdlp":
        # the root, at least one LP completion, and nodes alone or batched
        require(on_card >= 2, f"{name}: {on_card} PDLP solves on the card")
    return sol


def phase_fj_chunk(name, p):
    """One FJ chunk on `p` on the card, as solve_mip's engine steps it:
    the scoring block, the climbers, the chunk's wall (host clock around a
    synchronised chunk), its device time (CUDA events) and its full
    rescorings (fj_chunk), after a warm chunk."""
    import torch

    from cuopt_torch.mip.feasibility_jump import FjEngine, fj_chunk
    from cuopt_torch.mip.solve import FJ_DECAY, FJ_MARGIN

    rng = np.random.default_rng(1)
    eng = FjEngine(p, [rng.uniform(0, 1, p.n_variables)], device="cuda",
                   decay=FJ_DECAY, margin=FJ_MARGIN)
    eng.step()  # warm: builds the step's CUDA graph
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    stats = {}
    t0 = time.perf_counter()
    start.record()
    batch = fj_chunk(eng.p, eng.batch, eng.steps_per_chunk, eng.block,
                     stats)
    stop.record()
    stop.synchronize()
    wall = time.perf_counter() - t0
    m, Lc = eng.p.col_vals.shape
    log(f"[mip] {name}: FJ chunk of {eng.steps_per_chunk} steps, "
        f"{eng.batch_size} climbers, Lc {Lc}, K {3 * Lc + 2}, scoring "
        f"block {eng.block} of {m} variables: wall {wall:.4f} s "
        f"({1e3 * wall / eng.steps_per_chunk:.3f} ms a step), device "
        f"{start.elapsed_time(stop) / 1e3:.4f} s, "
        f"{stats.get('full_rescores', 0)} full rescorings of a climber, "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    require(bool(torch.isfinite(batch.act).all()), f"{name}: FJ act")


# ------------------------------------------------------- phases 15-16
GHC_200_1 = (2439.01, 21)  # scripts/bks_synth_baseline.json
ROUTING_RTOL, ROUTING_ATOL, ROUTING_TIE = 1e-5, 1e-3, 1e-3


def host_route_check(inst, routes):
    """(max time-window violation, max capacity excess) of the routes, an
    order list per vehicle in serve-order ids, recomputed in float64 on
    the host from the instance's own data (depot 0, customer o at node
    o + 1, travel time = distance)."""
    dist = inst.cost_matrix()
    tw_e = inst.tw_early if inst.tw_early is not None else \
        np.zeros(len(inst.xy))
    tw_l = inst.tw_late if inst.tw_late is not None else \
        np.full(len(inst.xy), np.inf)
    svc = inst.service if inst.service is not None else np.zeros(len(inst.xy))
    tw_viol = cap_viol = 0.0
    for r in routes:
        if not r:
            continue
        t, at = float(tw_e[0]), 0
        for o in r:
            node = o + 1
            t = max(t + dist[at, node], tw_e[node])
            tw_viol = max(tw_viol, t - tw_l[node])
            t += svc[node]
            at = node
        tw_viol = max(tw_viol, t + dist[at, 0] - tw_l[0])
        cap_viol = max(cap_viol, float(inst.demand[np.asarray(r) + 1].sum())
                       - inst.capacity)
    return tw_viol, cap_viol


def _ls_instrumented(stats):
    """Wrap the solver's _local_search so that every call adds its rounds,
    evaluation wall and CUDA-event device time to `stats`, and the host
    readbacks made inside it (local_search.readbacks). Returns a function
    that restores the original."""
    from cuopt_torch.routing import local_search as ls
    from cuopt_torch.routing import solver as rs

    orig = rs._local_search

    def wrapped(*a, **k):
        r0 = ls.readbacks
        try:
            return orig(*a, round_stats=stats, **k)
        finally:
            stats["readbacks"] = stats.get("readbacks", 0) + \
                ls.readbacks - r0

    rs._local_search = wrapped
    return lambda: setattr(rs, "_local_search", orig)


def _profile_rounds(name, fn, n=3):
    """One LS round's move evaluation `fn()` (it ends in its readback):
    its unprofiled wall per call (mean of n after a warm call), then n
    calls under torch.profiler for the device's busy time and kernel
    launches per call, its idle share (1 - busy / wall) and the three
    kernels that take most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    wall = (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e3 / n  # ms per call
    launches = sum(r[2] for r in rows) / n
    log(f"[routing] {name}: one round's evaluation: wall "
        f"{1e3 * wall:.3f} ms, device busy {busy:.3f} ms, idle share "
        f"{1 - busy / (1e3 * wall):.3f}, {launches:.0f} kernel launches")
    for key, us, count in rows[:3]:
        log(f"[routing] {name}:   {us / 1e3 / n:8.3f} ms  {count // n:5d} x"
            f"  {key[:80]}")


def _ls_line(stats):
    n = max(stats.get("rounds", 0), 1)
    return (f"{stats.get('rounds', 0)} LS rounds, per round: wall "
            f"{1e3 * stats.get('eval_s', 0.0) / n:.3f} ms, device "
            f"{stats.get('eval_device_ms', 0.0) / n:.3f} ms (CUDA events "
            f"from the first launch to the readback), host readbacks "
            f"{stats.get('readbacks', 0) / n:.3f}")


def phase_routing_gh200():
    """Phase 15, routing-gh200-C1: Solve on the card, 15 s, seed 0, on
    synth_gh_instance(200, "C", 1) (GHC_200_1 of
    scripts/bks_benchmark.py). Requires status 0, every customer served
    exactly once, time windows and capacity kept in a float64 recheck on
    the host, and a cost at most 0.97 times the port's cheapest insertion
    (tests/test_bks_regression.py's rule)."""
    import torch

    from cuopt_torch.io.vrp import solution_cost, synth_gh_instance
    from cuopt_torch.routing import Solve, SolverSettings
    from cuopt_torch.routing.construction import cheapest_insertion
    from cuopt_torch.routing.internal import build_problem

    inst = synth_gh_instance(200, "C", 1)
    dm = inst.to_data_model()
    prob = build_problem(dm)
    t0 = time.perf_counter()
    base_routes, base_un = cheapest_insertion(prob)
    base = sum(prob.route_cost(v, r) for v, r in base_routes.items() if r)
    log(f"[routing] GHC_200_1: cheapest insertion {base:.2f} with "
        f"{sum(1 for r in base_routes.values() if r)} vehicles, "
        f"{len(base_un)} unassigned, {time.perf_counter() - t0:.2f} s")
    s = SolverSettings()
    s.time_limit = 15  # cut from 30 s to keep the smoke near 8 minutes
    s.seed = 0
    stats = {}
    restore = _ls_instrumented(stats)
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        sol = Solve(dm, s)
        wall = time.perf_counter() - t0
    finally:
        restore()
    require(sol.get_status() == 0, f"GHC_200_1: status {sol.get_status()}"
            f" ({sol.get_message()})")
    cost, used = solution_cost(inst, sol)
    ref_cost, ref_veh = GHC_200_1
    log(f"[routing] GHC_200_1: cost {cost:.2f} with {used} vehicles "
        f"(baseline {ref_cost} with {ref_veh}: gap "
        f"{100 * (cost - ref_cost) / ref_cost:+.2f}%, "
        f"{used - ref_veh:+d} vehicles), wall {wall:.2f} s, "
        f"{_ls_line(stats)}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    table = sol.get_route()
    served = table[np.isin(table["type"], ["Delivery", "Pickup"])]
    ids = np.sort(served["route"])  # order ids; order o at node o + 1
    require(np.array_equal(ids, np.arange(200)),
            "GHC_200_1: not every customer served exactly once")
    routes = []
    for v in np.unique(served["truck_id"]):
        sub = served[served["truck_id"] == v]
        order = np.argsort(sub["arrival_stamp"], kind="stable")
        routes.append(sub["route"][order].tolist())
    tw_viol, cap_viol = host_route_check(inst, routes)
    log(f"[routing] GHC_200_1: host float64 recheck: max time-window "
        f"violation {tw_viol:.3e}, max capacity excess {cap_viol:.3e}")
    require(tw_viol <= 1e-6 and cap_viol <= 1e-9,
            "GHC_200_1: a route breaks its time windows or capacity")
    require(cost <= 0.97 * base,
            f"GHC_200_1: cost {cost:.2f} above 0.97 x {base:.2f}")
    require(stats.get("rounds", 0) >= 1, "GHC_200_1: no LS round")
    # the evaluator of one LS round, on the solution's routes
    from cuopt_torch.routing import local_search as ls
    from cuopt_torch.routing.solver import _pad_len, _routes_to_arrays

    lsp = ls.build_ls_problem(prob, device="cuda")
    final = {v: [] for v in range(prob.n_fleet)}
    for v, r in zip(np.unique(served["truck_id"]), routes):
        final[int(v)] = r
    R, lens = _routes_to_arrays(prob, final, _pad_len(final, headroom=12))
    _profile_rounds("GHC_200_1", lambda: ls.to_host(
        ls.evaluate_moves_topk(lsp, R, lens)))


def _same_moves(a, b):
    """Packed (K, 6) candidate rows of evaluate_moves_topk: deltas within
    rtol 1e-5 / atol 1e-3, and where the moves differ the delta ties with
    another candidate of its family within 1e-3. Returns the max delta
    difference and the count of rows that differ (by ties)."""
    d = np.abs(a[:, 0] - b[:, 0])
    require(np.all(d <= ROUTING_ATOL + ROUTING_RTOL * np.abs(b[:, 0])),
            f"tile deltas differ by up to {d.max():.3e}")
    require(np.array_equal(a[:, 1], b[:, 1]), "tile move kinds differ")
    differ = np.flatnonzero(np.any(a[:, 2:] != b[:, 2:], axis=1))
    for i in differ:
        fam = a[:, 1] == a[i, 1]
        require(np.sum(np.abs(a[fam, 0] - a[i, 0]) <= ROUTING_TIE) >= 2,
                f"tile move {i} differs without a tie: {a[i]} / {b[i]}")
    return float(d[b[:, 0] < 1e11].max(initial=0.0)), len(differ)


def phase_routing_4k():
    """Phase 16, routing-4k-RC7: synth_gh_instance(4000, "RC", seed=7),
    scripts/routing_scale_bench.py's instance (fleet 409: the tiled
    path). build_problem, build_ls_problem on the card,
    batched_construction, then _local_search(max_rounds=20). Requires
    every order at most once, every route feasible on the host, and a
    cost after LS below construction's. Then one tile's
    evaluate_moves_topk on the card against the port on the CPU from the
    same inputs."""
    import torch

    from cuopt_torch.io.vrp import synth_gh_instance
    from cuopt_torch.routing import local_search as ls
    from cuopt_torch.routing.construction import batched_construction
    from cuopt_torch.routing.internal import build_problem
    from cuopt_torch.routing.solver import (
        _LS_GROUP,
        _grouped_moves,
        _local_search,
        _pad_len,
        _routes_to_arrays,
    )
    from cuopt_torch.utils.timer import Timer

    name = "routing-4k-RC7"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    inst = synth_gh_instance(4000, "RC", seed=7)
    prob = build_problem(inst.to_data_model())
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    lsp = ls.build_ls_problem(prob, device="cuda")
    prob._lsp_cache = lsp
    torch.cuda.synchronize()
    t_lsp = time.perf_counter() - t0
    r0 = ls.readbacks
    t0 = time.perf_counter()
    routes, unassigned = batched_construction(prob, lsp)
    t_con = time.perf_counter() - t0
    con_rounds = ls.readbacks - r0  # one readback a construction round
    mem_con = torch.cuda.max_memory_allocated() / 1e9

    def cost(rs):
        return sum(prob.route_cost(v, r) for v, r in rs.items() if r)

    c_con = cost(routes)
    log(f"[routing] {name}: {prob.n_serve} orders, fleet {prob.n_fleet}, "
        f"build_problem {t_build:.2f} s, build_ls_problem {t_lsp:.2f} s, "
        f"construction {t_con:.2f} s in {con_rounds} rounds: cost "
        f"{c_con:.2f}, {sum(1 for r in routes.values() if r)} vehicles, "
        f"{len(unassigned)} unassigned, peak device memory {mem_con:.3f} GB")
    require(prob.n_fleet > int(1.5 * _LS_GROUP), f"{name}: not tiled")
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    r0 = ls.readbacks
    t0 = time.perf_counter()
    routes = _local_search(prob, lsp, routes, Timer(300.0), max_rounds=20,
                           round_stats=stats)
    t_ls = time.perf_counter() - t0
    stats["readbacks"] = ls.readbacks - r0
    c_ls = cost(routes)
    log(f"[routing] {name}: LS {t_ls:.2f} s, cost {c_ls:.2f} "
        f"({100 * (c_ls - c_con) / c_con:+.2f}%), {_ls_line(stats)}, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f}"
        f" GB")
    seen = [o for r in routes.values() for o in r]
    require(len(seen) == len(set(seen)), f"{name}: an order served twice")
    require(len(seen) + len(unassigned) == prob.n_serve,
            f"{name}: orders lost")
    require(all(prob.route_feasible(v, r) for v, r in routes.items() if r),
            f"{name}: a route is infeasible on the host")
    require(c_ls < c_con, f"{name}: LS did not lower the cost")
    require(stats["rounds"] >= 1, f"{name}: no LS round")
    R, lens = _routes_to_arrays(prob, routes, _pad_len(routes, headroom=12))
    _profile_rounds(name, lambda: _grouped_moves(prob, lsp, R, lens, 0))

    # one tile on the card and on the CPU, from the same inputs
    idx = np.arange(_LS_GROUP)
    lsp_cpu = ls.build_ls_problem(prob, device="cpu")
    outs = []
    for p in (lsp, lsp_cpu):
        sub = ls.subset_ls_problem(p, idx)
        t0 = time.perf_counter()
        outs.append(ls.to_host(ls.evaluate_moves_topk(sub, R[idx],
                                                      lens[idx])))
        outs.append(time.perf_counter() - t0)
    err, n_tie = _same_moves(outs[0], outs[2])
    log(f"[routing] {name}: one tile ({_LS_GROUP} routes, L "
        f"{R.shape[1]}) on the card ({1e3 * outs[1]:.2f} ms) and on the "
        f"CPU ({1e3 * outs[3]:.2f} ms): max delta difference {err:.3e}, "
        f"{n_tie} of {len(outs[0])} candidates differ by a tie")


# ------------------------------------------------------------------- main
# ------------------------------------------------------- phases 17-18
SURFACE_RTOL = 1e-3  # a surface's LP answer against HiGHS
SERVICE_DEADLINE = 180.0  # seconds any one request may take end to end


def write_mps(prob, path):
    """Free-format MPS of a one-sided-row problem (rows L, G or E, columns
    with integer MARKERs, BOUNDS), numbers by repr so that they read back
    exactly. cuopt_tpu has no MPS writer, so the package has none either;
    the smoke keeps its own."""
    n, m = prob.n_constraints, prob.n_variables
    lc, uc = prob.constraint_lower_bounds, prob.constraint_upper_bounds
    require(not np.any(np.isfinite(lc) & np.isfinite(uc) & (lc != uc)),
            "write_mps takes one-sided or equality rows")
    kind = np.where(lc == uc, "E", np.where(np.isfinite(uc), "L", "G"))
    rhs = np.where(np.isfinite(uc), uc, lc)
    lines = ["NAME SMOKE", "ROWS", " N OBJ"]
    lines += [f" {k} R{i}" for i, k in enumerate(kind)]
    lines.append("COLUMNS")
    rows = np.repeat(np.arange(n), np.diff(prob.offsets))
    order = np.argsort(prob.indices, kind="stable")
    cols, crow = prob.indices[order], rows[order]
    cval = np.asarray(prob.values, float)[order]
    starts = np.searchsorted(cols, np.arange(m + 1))
    c = np.asarray(prob.objective_coefficients, float)
    integer = np.asarray(prob.variable_types) == "I"
    in_int = False
    for j in range(m):
        if integer[j] != in_int:
            in_int = not in_int
            lines.append(f" M{j} 'MARKER' "
                         f"'{'INTORG' if in_int else 'INTEND'}'")
        lines.append(f" C{j} OBJ {float(c[j])!r}")
        lines += [f" C{j} R{r} {float(v)!r}"
                  for r, v in zip(crow[starts[j]:starts[j + 1]],
                                  cval[starts[j]:starts[j + 1]])]
    if in_int:
        lines.append(f" M{m} 'MARKER' 'INTEND'")
    lines.append("RHS")
    lines += [f" RHS R{i} {float(v)!r}" for i, v in enumerate(rhs) if v]
    lines.append("BOUNDS")
    for j, (lo, hi) in enumerate(zip(prob.variable_lower_bounds,
                                     prob.variable_upper_bounds)):
        require(np.isfinite(lo), "write_mps takes finite lower bounds")
        if lo:
            lines.append(f" LO BND C{j} {float(lo)!r}")
        if np.isfinite(hi):
            lines.append(f" UP BND C{j} {float(hi)!r}")
    lines.append("ENDATA")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def lp_payload(prob, **solver_config):
    """The solver service's LP JSON payload of a problem."""
    def bounds(a):
        return ["inf" if v == np.inf else "ninf" if v == -np.inf
                else float(v) for v in np.asarray(a, float)]

    out = {
        "csr_constraint_matrix": {
            "offsets": np.asarray(prob.offsets).tolist(),
            "indices": np.asarray(prob.indices).tolist(),
            "values": np.asarray(prob.values, float).tolist()},
        "objective_data": {"coefficients": np.asarray(
            prob.objective_coefficients, float).tolist()},
        "constraint_bounds": {
            "lower_bounds": bounds(prob.constraint_lower_bounds),
            "upper_bounds": bounds(prob.constraint_upper_bounds)},
        "variable_bounds": {
            "lower_bounds": bounds(prob.variable_lower_bounds),
            "upper_bounds": bounds(prob.variable_upper_bounds)},
        "solver_config": dict(solver_config),
    }
    if np.any(np.asarray(prob.variable_types) == "I"):
        out["variable_types"] = np.asarray(prob.variable_types).tolist()
    return out


def _entry_env(base=None):
    """The environment of a process of the port's entry points: on their
    default device, the card."""
    env = dict(os.environ if base is None else base)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    env.pop("CUOPT_TORCH_DEVICE", None)
    return env


def _cli(name, args, timeout=600):
    """python -m cuopt_torch.cli args: (wall, {key: value of its printed
    lines})."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "cuopt_torch.cli", *args,
                        "--log_to_console", "false"], cwd=ROOT,
                       env=_entry_env(), capture_output=True, text=True,
                       timeout=timeout)
    wall = time.perf_counter() - t0
    require(r.returncode == 0, f"CLI {name}: exit {r.returncode}: "
                               f"{r.stderr[-2000:]}")
    lines = dict(line.split(":", 1) for line in r.stdout.splitlines()
                 if ":" in line)
    return wall, {k.strip(): v.strip() for k, v in lines.items()}


def _capi_create(lib, prob):
    """cuOptCreateProblem on a one-sided-row problem: (status, handle,
    the arrays, which must outlive the handle's use)."""
    import ctypes

    P = ctypes.POINTER
    lc, uc = prob.constraint_lower_bounds, prob.constraint_upper_bounds
    arrays = [
        np.ascontiguousarray(prob.objective_coefficients, np.float64),
        np.ascontiguousarray(prob.offsets, np.int32),
        np.ascontiguousarray(prob.indices, np.int32),
        np.ascontiguousarray(prob.values, np.float64),
        np.where(lc == uc, "E", np.where(np.isfinite(uc), "L", "G"))
        .astype("S1").tobytes(),
        np.ascontiguousarray(np.where(np.isfinite(uc), uc, lc), np.float64),
        np.ascontiguousarray(prob.variable_lower_bounds, np.float64),
        np.ascontiguousarray(prob.variable_upper_bounds, np.float64),
        np.asarray(prob.variable_types).astype("S1").tobytes(),
    ]

    def ptr(a):
        if isinstance(a, bytes):
            return a
        ct = ctypes.c_int32 if a.dtype == np.int32 else ctypes.c_double
        return a.ctypes.data_as(P(ct))

    handle = ctypes.c_void_p()
    status = lib.cuOptCreateProblem(
        prob.n_constraints, prob.n_variables, 1, 0.0,
        *(ptr(a) for a in arrays), ctypes.byref(handle))
    return status, handle, arrays


def _capi_solve(lib, handle, method):
    """cuOptSolve with `method`: (termination status, objective,
    seconds)."""
    import ctypes

    settings, sol = ctypes.c_void_p(), ctypes.c_void_p()
    require(lib.cuOptCreateSolverSettings(ctypes.byref(settings)) == 0,
            "C ABI: cuOptCreateSolverSettings")
    for name, value in ((b"method", str(method).encode()),
                        (b"log_to_console", b"false")):
        require(lib.cuOptSetParameter(settings, name, value) == 0,
                f"C ABI: cuOptSetParameter {name}")
    t0 = time.perf_counter()
    st = lib.cuOptSolve(handle, settings, ctypes.byref(sol))
    wall = time.perf_counter() - t0
    require(st == 0, f"C ABI: cuOptSolve returned {st}")
    term, obj = ctypes.c_int32(), ctypes.c_double()
    lib.cuOptGetTerminationStatus(sol, ctypes.byref(term))
    lib.cuOptGetObjectiveValue(sol, ctypes.byref(obj))
    lib.cuOptDestroySolution(ctypes.byref(sol))
    lib.cuOptDestroySolverSettings(ctypes.byref(settings))
    return term.value, obj.value, wall


def phase_surface(p50, p2k, highs_2k, workdir):
    """Phase 17: the user-facing surface on the card. The façade
    (linear_programming.Solve with registry settings, float32 PDLP) on
    staircase-50k through row_pass_atomic; the CLI as a process at its
    defaults (Concurrent, float64) on staircase-50k written as MPS, with
    the .sol read back, and on twelve-binaries; the C ABI in this process
    through ctypes (staircase-2k by cuOptCreateProblem and the dual
    simplex, staircase-50k by cuOptReadProblem and PDLP); the standalone C
    caller csrc/c_api_check.c as a process. Returns the kernels' launches
    in the façade's solve."""
    import ctypes
    import sysconfig

    import torch

    from cuopt_torch import c_api_embed
    from cuopt_torch import constants as C
    from cuopt_torch.io import parse_mps
    from cuopt_torch.kernels.build import BUILDER, embed_env
    from cuopt_torch.linear_programming import Solve, SolverSettings
    from cuopt_torch.lp import pdhg_fused as pf

    highs = HIGHS_OBJ[50_000]

    def rel(obj, ref):
        return abs(obj - ref) / abs(ref)

    # the façade
    s = SolverSettings()
    for name, value in (
            (C.CUOPT_METHOD, C.CUOPT_METHOD_PDLP),
            (C.CUOPT_ITERATION_LIMIT, 20000),
            (C.CUOPT_LOG_TO_CONSOLE, "false"),
            *((t, 1e-4) for t in (
                C.CUOPT_ABSOLUTE_PRIMAL_TOLERANCE,
                C.CUOPT_RELATIVE_PRIMAL_TOLERANCE,
                C.CUOPT_ABSOLUTE_DUAL_TOLERANCE,
                C.CUOPT_RELATIVE_DUAL_TOLERANCE,
                C.CUOPT_ABSOLUTE_GAP_TOLERANCE,
                C.CUOPT_RELATIVE_GAP_TOLERANCE))):
        s.set_parameter(name, value)
    s.pdlp.dtype = "float32"
    reset_counts()
    t0 = time.perf_counter()
    sol = Solve(p50, s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    obj = sol.get_primal_objective()
    info = sol.get_additional_termination_information()
    log(f"[surface] facade staircase-50k (float32 PDLP): "
        f"{sol.get_termination_reason()}, objective {obj:.6f} (rel err "
        f"{rel(obj, highs):.2e}), {info['iterations']} steps, "
        f"{info['attempts']} attempts, wall {wall:.3f} s, launches "
        f"{launches}")
    require(sol.get_termination_reason() == "Optimal", "facade: status")
    require(rel(obj, highs) <= SURFACE_RTOL, "facade: objective")
    for k in ("row_pass_atomic", "pdhg_primal", "pdhg_row_sums",
              "pdhg_commit"):
        require(launches[k] == info["attempts"] > 0,
                f"facade: not every attempt through {k}")

    # the CLI on staircase-50k, at its defaults
    mps50 = os.path.join(workdir, "staircase-50k.mps")
    t0 = time.perf_counter()
    write_mps(p50, mps50)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    parsed = parse_mps(mps50)
    t_parse = time.perf_counter() - t0
    def csr(p):
        import scipy.sparse as sp

        return sp.csr_matrix((p.values, p.indices, p.offsets),
                             shape=(p.n_constraints, p.n_variables))

    require(parsed.nnz == p50.nnz and (csr(parsed) != csr(p50)).nnz == 0
            and np.array_equal(parsed.objective_coefficients,
                               p50.objective_coefficients),
            "MPS: the 50k staircase read back")
    log(f"[surface] staircase-50k.mps: {os.path.getsize(mps50) / 1e6:.1f} "
        f"MB, {p50.nnz} nonzeros, written in {t_write:.2f} s, native "
        f"parse {t_parse:.3f} s")
    sol_path = os.path.join(workdir, "staircase-50k.sol")
    wall, out = _cli("staircase-50k", [mps50, "--solution_file", sol_path])
    obj = float(out["Objective"])
    log(f"[surface] CLI staircase-50k (defaults: Concurrent, float64): "
        f"{out['Status']}, objective {obj:.6f} (rel err "
        f"{rel(obj, highs):.2e}), solve {out.get('Time')}, wall "
        f"{wall:.2f} s")
    require(out["Status"] == "Optimal", "CLI staircase-50k: status")
    require(rel(obj, highs) <= SURFACE_RTOL, "CLI staircase-50k: objective")
    with open(sol_path) as f:
        lines = f.read().splitlines()
    require(lines[0] == "# Status: Optimal" and
            len(lines) == 2 + p50.n_variables,
            "CLI staircase-50k: .sol file")
    x = np.array([float(v.split()[1]) for v in lines[2:]])
    x_obj = float(p50.objective_coefficients @ x)
    res, b_norm = host_primal_residual(p50, x)
    log(f"[surface] CLI staircase-50k .sol: objective of its x "
        f"{x_obj:.6f}, host primal residual {res:.3e} (|b| {b_norm:.3e})")
    require(rel(x_obj, highs) <= SURFACE_RTOL, "CLI .sol: objective of x")
    require(res <= 1e-4 + 1e-4 * b_norm, "CLI .sol: primal residual")

    # the CLI on twelve-binaries (integer markers)
    mps12 = os.path.join(workdir, "twelve-binaries.mps")
    write_mps(twelve_binaries(), mps12)
    wall, out = _cli("twelve-binaries", [mps12])
    log(f"[surface] CLI twelve-binaries: {out['Status']}, objective "
        f"{out['Objective']}, wall {wall:.2f} s")
    require(out["Status"] == "Optimal" and float(out["Objective"]) == -82,
            "CLI twelve-binaries")

    # the C ABI in this process (built by phase 1)
    t0 = time.perf_counter()
    lib = c_api_embed.load_library()
    log(f"[surface] C ABI library loaded in "
        f"{time.perf_counter() - t0:.3f} s")
    st, handle, keep = _capi_create(lib, p2k)
    require(st == 0, f"C ABI: cuOptCreateProblem returned {st}")
    term, obj, wall = _capi_solve(lib, handle, C.CUOPT_METHOD_DUAL_SIMPLEX)
    log(f"[surface] C ABI staircase-2k (cuOptCreateProblem, dual "
        f"simplex): status {term}, objective {obj:.10f} (HiGHS "
        f"{highs_2k:.10f}, rel err {rel(obj, highs_2k):.2e}), "
        f"{wall:.3f} s")
    require(term == C.CUOPT_TERIMINATION_STATUS_OPTIMAL and
            rel(obj, highs_2k) <= 1e-9, "C ABI staircase-2k")
    lib.cuOptDestroyProblem(ctypes.byref(handle))
    del keep
    handle = ctypes.c_void_p()
    t0 = time.perf_counter()
    st = lib.cuOptReadProblem(mps50.encode(), ctypes.byref(handle))
    t_read = time.perf_counter() - t0
    require(st == 0, f"C ABI: cuOptReadProblem returned {st}")
    term, obj, wall = _capi_solve(lib, handle, C.CUOPT_METHOD_PDLP)
    log(f"[surface] C ABI staircase-50k (cuOptReadProblem {t_read:.3f} s, "
        f"PDLP float64): status {term}, objective {obj:.6f} (rel err "
        f"{rel(obj, highs):.2e}), {wall:.3f} s")
    require(term == C.CUOPT_TERIMINATION_STATUS_OPTIMAL and
            rel(obj, highs) <= SURFACE_RTOL, "C ABI staircase-50k")
    lib.cuOptDestroyProblem(ctypes.byref(handle))

    # the standalone C caller, which links libpython
    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        log("[surface] c_api_check: not run: this Python has no shared "
            "libpython (Py_ENABLE_SHARED is 0) to link a C caller against")
        return launches
    exe = BUILDER.c_api_check()
    t0 = time.perf_counter()
    r = subprocess.run([str(exe), str(C.CUOPT_METHOD_DUAL_SIMPLEX)],
                       env=_entry_env(embed_env()),
                       capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    require(r.returncode == 0, f"c_api_check: exit {r.returncode}: "
                               f"{r.stdout[-500:]} {r.stderr[-1500:]}")
    fields = r.stdout.split()
    status, objective = int(fields[1]), float(fields[3])
    # the same LP through the library in this process
    from cuopt_torch.problem.data_model import OptimizationProblem

    two_rows = OptimizationProblem.from_dense(
        np.array([[3.0, 4.0], [2.7, 10.1]]), c=np.array([-0.2, -0.1]),
        constraint_lower=np.full(2, -np.inf),
        constraint_upper=np.array([5.4, 4.9]), variable_lower=np.zeros(2),
        variable_upper=np.full(2, np.inf))
    st, handle, keep = _capi_create(lib, two_rows)
    require(st == 0, "C ABI: the two-row LP")
    term, obj, _ = _capi_solve(lib, handle, C.CUOPT_METHOD_DUAL_SIMPLEX)
    lib.cuOptDestroyProblem(ctypes.byref(handle))
    del keep
    log(f"[surface] c_api_check (a C process): "
        f"{r.stdout.strip()}, wall {wall:.2f} s; in this process: status "
        f"{term}, objective {obj!r}")
    require(status == term == C.CUOPT_TERIMINATION_STATUS_OPTIMAL and
            objective == obj and abs(obj + 0.36) <= 1e-12,
            "c_api_check: not the in-process answer")
    return launches


def _http(base, method, path, body=None, ctype="application/json",
          timeout=60.0):
    """(status, body bytes) of one request."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, data=body, method=method,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as exc:
        with exc:
            return exc.code, exc.read()


def _submit(base, payload, ctype="application/json"):
    body = payload if isinstance(payload, bytes) else \
        json.dumps(payload).encode()
    status, out = _http(base, "POST", "/cuopt/request", body, ctype)
    require(status == 200, f"service: submit answered {status}: "
                           f"{out[:300]!r}")
    return json.loads(out)["reqId"]


def _poll(base, req_id, deadline=SERVICE_DEADLINE):
    """(status, JSON body) of the first answer other than 202."""
    end = time.monotonic() + deadline
    while time.monotonic() < end:
        status, out = _http(base, "GET", f"/cuopt/solution/{req_id}")
        if status != 202:
            return status, json.loads(out)
        time.sleep(0.05)
    raise SmokeFailure(f"service: {req_id} unanswered after {deadline} s")


def _gh_payload(inst, time_limit):
    """The routing payload of a synthetic Gehring-Homberger instance. The
    schema takes integer task time windows (cuopt_tpu's TaskData, after
    the reference's), so each window is rounded inward: a route within
    them keeps the instance's own windows."""
    dist = inst.cost_matrix()
    nv, n = inst.n_vehicles, inst.n_customers
    return {
        "cost_matrix_data": {"data": {"0": dist.tolist()}},
        "travel_time_matrix_data": {"data": {"0": dist.tolist()}},
        "fleet_data": {
            "vehicle_locations": [[0, 0]] * nv,
            "capacities": [[int(inst.capacity)] * nv],
            "vehicle_time_windows": [[float(inst.tw_early[0]),
                                      float(inst.tw_late[0])]] * nv},
        "task_data": {
            "task_locations": list(range(1, n + 1)),
            "demand": [inst.demand[1:].astype(int).tolist()],
            "task_time_windows": [
                [int(np.ceil(e)), int(np.floor(lt))] for e, lt in
                zip(inst.tw_early[1:], inst.tw_late[1:])],
            "service_times": inst.service[1:].astype(int).tolist()},
        "solver_config": {"time_limit": time_limit},
    }


def _compute_apps():
    """nvidia-smi's processes with a context on the card, as
    "pid, used memory" lines."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,"
                          "used_memory", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi: {out.stderr}")
    return [line.strip() for line in out.stdout.splitlines()
            if line.strip()]


def _children(pid):
    out = subprocess.run(["ps", "-o", "pid=", "--ppid", str(pid)],
                         capture_output=True, text=True, timeout=30)
    return [int(p) for p in out.stdout.split()]


def _alive(pid):
    try:
        with open(f"/proc/{pid}/status") as f:
            return "\nState:\tZ" not in f.read()
    except FileNotFoundError:
        return False


def phase_service(p50, workdir):
    """Phase 18: python -m cuopt_torch.server with one worker on the card
    (its default device). staircase-50k's LP as JSON (about 400k
    nonzeros, through shared memory) and as msgpack+zlib, OPTIMAL within
    1e-3 of HiGHS; twelve-binaries at -82 with an incumbent streamed;
    GHC_200_1 for 10 s, checked as phase 15 checks it; an abort (410), an
    unknown id (404), a pickle body (415); an LP through the thin client
    and one through cuopt_sh. nvidia-smi must list the worker while the
    server is up, and no process of the server may be left after it."""
    import socket

    from cuopt_torch.clients import CuOptServiceSelfHostClient
    from cuopt_torch.io.vrp import synth_gh_instance
    from cuopt_torch.routing.construction import cheapest_insertion
    from cuopt_torch.routing.internal import build_problem
    from cuopt_torch.utils.msgpack_codec import packb

    highs = HIGHS_OBJ[50_000]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    server_log = open(os.path.join(workdir, "server.log"), "w")
    apps_before = _compute_apps()
    t_start = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "cuopt_torch.server", "-p", str(port), "-i",
         "127.0.0.1", "-d", "1"], cwd=ROOT, env=_entry_env(),
        stdout=server_log, stderr=subprocess.STDOUT)
    pids = []
    try:
        # live (/cuopt/health) answers once the HTTP server listens, ready
        # (/v2/health/ready) once its worker has passed its health check
        end = time.monotonic() + 120
        t_live = None
        while True:
            try:
                if t_live is None and _http(
                        base, "GET", "/cuopt/health", timeout=5)[0] == 200:
                    t_live = time.perf_counter() - t_start
                if t_live is not None and _http(
                        base, "GET", "/v2/health/ready", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            require(proc.poll() is None and time.monotonic() < end,
                    "service: the server's worker did not become ready")
            time.sleep(0.2)
        log(f"[service] server live in {t_live:.2f} s, ready (its worker "
            f"past its health check) in {time.perf_counter() - t_start:.2f}"
            f" s")

        # staircase-50k as JSON
        payload = lp_payload(p50)
        body = json.dumps(payload).encode()
        answers = {}
        for name, data, ctype in (
                ("JSON", body, "application/json"),
                ("msgpack+zlib", zlib.compress(packb(payload)),
                 "application/vnd.msgpack+zlib")):
            t0 = time.perf_counter()
            req_id = _submit(base, data, ctype)
            t_submit = time.perf_counter() - t0
            status, res = _poll(base, req_id)
            wall = time.perf_counter() - t0
            require(status == 200, f"service LP {name}: {status} {res}")
            sol = res["response"]["solver_response"]["solution"]
            obj = sol["primal_objective"]
            answers[name] = obj
            log(f"[service] staircase-50k as {name} ({len(data) / 1e6:.1f} "
                f"MB): {sol['termination_reason']}, objective {obj:.6f} "
                f"(rel err {abs(obj - highs) / highs:.2e}), submit to "
                f"result {wall:.3f} s (the submit's answer after "
                f"{t_submit:.3f} s), solve {sol['solver_time']:.3f} s as "
                f"reported")
            require(sol["termination_reason"] == "Optimal" and
                    abs(obj - highs) / highs <= SURFACE_RTOL,
                    f"service LP {name}")
            if not pids:
                # nvidia-smi names processes by the host's pids, not this
                # machine's, so the worker shows as one more compute app
                pids = _children(proc.pid)
                apps = _compute_apps()
                log(f"[service] server {proc.pid}, its processes {pids}; "
                    f"nvidia-smi compute apps: {apps} (before the server: "
                    f"{apps_before})")
                require(len(apps) > len(apps_before),
                        "service: nvidia-smi lists no process of the server")

        # twelve-binaries: incumbents streamed
        t0 = time.perf_counter()
        req_id = _submit(base, lp_payload(twelve_binaries(), time_limit=60))
        status, res = _poll(base, req_id)
        wall = time.perf_counter() - t0
        sol = res["response"]["solver_response"]["solution"]
        inc = json.loads(_http(base, "GET",
                               f"/cuopt/solution/{req_id}/incumbents")[1])
        log(f"[service] twelve-binaries: {sol['termination_reason']}, "
            f"objective {sol['primal_objective']}, "
            f"{len(inc['incumbents'])} incumbents, wall {wall:.3f} s")
        require(status == 200 and sol["termination_reason"] == "Optimal"
                and sol["primal_objective"] == -82 and
                len(inc["incumbents"]) >= 1, "service twelve-binaries")

        # GHC_200_1, 10 s
        inst = synth_gh_instance(200, "C", 1)
        prob = build_problem(inst.to_data_model())
        base_routes, _ = cheapest_insertion(prob)
        base_cost = sum(prob.route_cost(v, r)
                        for v, r in base_routes.items() if r)
        t0 = time.perf_counter()
        status, res = _poll(base, _submit(base, _gh_payload(inst, 10)))
        wall = time.perf_counter() - t0
        require(status == 200, f"service GHC_200_1: {status} {res}")
        out = res["response"]["solver_response"]
        dist = inst.cost_matrix()
        routes, cost = [], 0.0
        for truck in out["vehicle_data"].values():
            orders = [int(t) for t in truck["task_id"] if t != "Depot"]
            if orders:
                routes.append(orders)
                cost += float(sum(dist[a, b] for a, b in
                                  zip(truck["route"], truck["route"][1:])))
        served = sorted(o for r in routes for o in r)
        tw_viol, cap_viol = host_route_check(inst, routes)
        log(f"[service] GHC_200_1, 10 s: status {out['status']}, cost "
            f"{cost:.2f} with {len(routes)} vehicles (cheapest insertion "
            f"{base_cost:.2f}; phase 15's 15 s Solve above), reported "
            f"{out['solution_cost']:.2f}, max time-window violation "
            f"{tw_viol:.3e}, capacity excess {cap_viol:.3e}, submit to "
            f"result {wall:.2f} s")
        require(out["status"] == 0, "service GHC_200_1: status")
        require(served == list(range(200)),
                "service GHC_200_1: not every order served once")
        require(tw_viol <= 1e-6 and cap_viol <= 1e-9,
                "service GHC_200_1: time windows or capacity broken")
        require(cost <= 0.97 * base_cost,
                f"service GHC_200_1: cost {cost:.2f} above 0.97 x "
                f"{base_cost:.2f}")

        # the rest of the request surface
        small = _gh_payload(synth_gh_instance(30, "C", 2), 2)
        req_id = _submit(base, small)
        status, res = _http(base, "DELETE", f"/cuopt/request/{req_id}")
        require(status == 200 and json.loads(res) == {"aborted": True},
                "service: abort")
        require(_poll(base, req_id)[0] == 410, "service: aborted not 410")
        require(_http(base, "GET", "/cuopt/solution/nope")[0] == 404,
                "service: unknown id not 404")
        require(_http(base, "POST", "/cuopt/request", b"x",
                      "application/pickle")[0] == 415,
                "service: pickle not 415")
        two_rows = {
            "csr_constraint_matrix": {"offsets": [0, 2, 4],
                                      "indices": [0, 1, 0, 1],
                                      "values": [3.0, 4.0, 2.7, 10.1]},
            "objective_data": {"coefficients": [-0.2, -0.1]},
            "constraint_bounds": {"upper_bounds": [5.4, 4.9],
                                  "lower_bounds": ["ninf", "ninf"]}}
        client = CuOptServiceSelfHostClient(
            ip="127.0.0.1", port=port, polling_interval=0.05,
            request_excess_timeout=SERVICE_DEADLINE)
        t0 = time.perf_counter()
        res = client.get_LP_solve(two_rows)
        sol = res["response"]["solver_response"]["solution"]
        log(f"[service] thin client: {sol['termination_reason']}, "
            f"objective {sol['primal_objective']}, "
            f"{time.perf_counter() - t0:.3f} s")
        require(sol["termination_reason"] == "Optimal" and
                abs(sol["primal_objective"] + 0.36) <= 1e-4,
                "service: thin client")
        data = os.path.join(workdir, "two_rows.json")
        with open(data, "w") as f:
            json.dump(two_rows, f)
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "cuopt_torch.clients.cuopt_sh", data,
             "-i", "127.0.0.1", "-p", str(port), "--poll-interval", "0.05"],
            cwd=ROOT, env=_entry_env(), capture_output=True, text=True,
            timeout=SERVICE_DEADLINE)
        require(r.returncode == 0, f"cuopt_sh: {r.stderr[-1000:]}")
        sol = json.loads(r.stdout)["response"]["solver_response"]["solution"]
        log(f"[service] cuopt_sh: {sol['termination_reason']}, objective "
            f"{sol['primal_objective']}, {time.perf_counter() - t0:.2f} s")
        require(sol["termination_reason"] == "Optimal" and
                abs(sol["primal_objective"] + 0.36) <= 1e-4,
                "service: cuopt_sh")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)
        server_log.close()
        end = time.monotonic() + 30
        while any(_alive(p) for p in pids) and time.monotonic() < end:
            time.sleep(0.2)
        left = [p for p in pids if _alive(p)]
        for p in left:  # the smoke stops every process it starts
            os.kill(p, 9)
    require(proc.returncode == 0, f"service: the server exited with "
                                  f"{proc.returncode} on SIGTERM")
    require(not left, f"service: processes {left} outlived the server")
    log(f"[service] the server and its processes {pids} stopped; "
        f"nvidia-smi compute apps: {_compute_apps()}")


# ----------------------------------------------------------- phase 19
HALO_N = 65_536  # 512 row tiles: 128 per shard on four shards
ISLANDS, MEMBERS, SWEEP_STEPS, EPOCHS = 4, 4, 8, 5


def _mesh_label(mesh):
    cards = len(set(mesh.devices))
    return f"{mesh.size} shards on {cards} card{'s' if cards > 1 else ''}"


def _f64_settings():
    """PDLPSolverSettings() defaults (float64), PDLP alone."""
    from cuopt_torch import constants as C
    from cuopt_torch.lp.settings import PDLPSolverSettings

    s = PDLPSolverSettings()
    s.method = C.CUOPT_METHOD_PDLP
    s.log_to_console = False
    return s


def _row_pass_launches():
    from cuopt_torch.lp import pdhg_fused as pf

    return sum(k.launches for k in pf.KERNELS)


def _halo_gates(op, D):
    """Why the single-exchange layout was or was not built."""
    T, tile = op.row_slabs.shape[0], op.tile
    why = []
    if op.n_rows != T * tile:
        why.append(f"{op.n_rows} rows are not {T} whole tiles")
    if T % D:
        why.append(f"{T} row tiles do not split over {D} shards")
    if op.spill_vals.numel() or op.t_spill_vals.numel():
        why.append(f"{op.spill_vals.numel()} + {op.t_spill_vals.numel()} "
                   f"entries spill")
    return "; ".join(why) or "none failed"


def sharded_majors_check(name, prob, mesh, majors=2):
    """`majors` float64 majors of `prob` on the block-band operator, split
    over `mesh`, against as many unsharded majors on the card from one
    state: x and y within 1e-9 (|a - b| <= 1e-9 (1 + |b|)), the same
    steps, kkt within 1e-8 relative. No row-pass kernel may launch.
    Returns the first shard's operator."""
    import torch

    from cuopt_torch.lp import pdlp
    from cuopt_torch.parallel import gather_state, shard_problem_and_state

    s = _f64_settings()
    solver = pdlp.PdlpSolver(prob, s, "cuda")
    dev = pdlp.build_device_problem(prob, solver.hp, torch.float64,
                                    "blockband", "cuda")
    st0 = pdlp.initial_state(dev, solver.hp, torch.float64)
    fn = pdlp.make_major_fn(solver.cfg)
    st1 = st0
    for _ in range(majors):
        st1, r1 = fn(dev, st1)
    sdev, sst = shard_problem_and_state(dev, st0, mesh)
    op = sdev.shards[0].op
    if op.halo_meta is not None:
        D, Lr, Lc, Hx, Hy, ty = op.halo_meta
        log(f"[multi] {name}, {_mesh_label(mesh)}: halo path, Hx {Hx}, "
            f"Hy {Hy}, ty {ty} (rows {Lr}, columns {Lc} per shard)")
    else:
        log(f"[multi] {name}, {_mesh_label(mesh)}: general path (all-gathered "
            f"windows): the halo gates failed: {_halo_gates(dev.op, mesh.size)}")
    before = _row_pass_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(majors):
        sst, r8 = fn(sdev, sst)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(_row_pass_launches() == before,
            f"{name}: the sharded majors launched a row-pass kernel")
    g = gather_state(sst)
    ex = float(((g.x - st1.x).abs() / (1 + st1.x.abs())).max())
    ey = float(((g.y - st1.y).abs() / (1 + st1.y.abs())).max())
    k1, k8 = float(r1["kkt_cur"]), float(r8["kkt_cur"])
    steps1, steps8 = int(st1.total_steps), int(g.total_steps)
    log(f"[multi] {name}, {_mesh_label(mesh)}: {majors} float64 majors "
        f"sharded against unsharded from one state: x within {ex:.2e}, y "
        f"within {ey:.2e}, steps {steps8} / {steps1}, kkt {k8:.12e} / "
        f"{k1:.12e}; sharded wall {wall:.3f} s, {r8['collectives']} "
        f"collectives in the last major (all shards)")
    require(ex <= 1e-9 and ey <= 1e-9,
            f"{name}: sharded x/y {ex:.2e}/{ey:.2e} from unsharded")
    require(steps8 == steps1, f"{name}: {steps8} steps against {steps1}")
    require(abs(k8 - k1) <= 1e-8 * abs(k1), f"{name}: kkt {k8} vs {k1}")
    del sdev, sst, dev
    return op


def sharded_step_times(name, prob, counts=(1, 2, 4)):
    """Prints the wall and CUDA-event ms per step of one float64 major on
    1, 2 and 4 shards of the card beside the unsharded step, and the
    collectives and bytes of one attempt."""
    import torch

    from cuopt_torch.lp import pdlp
    from cuopt_torch.parallel import (make_mesh, run_spmd,
                                      shard_problem_and_state)
    from cuopt_torch.parallel.sharding import attach_comm

    s = _f64_settings()
    solver = pdlp.PdlpSolver(prob, s, "cuda")
    dev = pdlp.build_device_problem(prob, solver.hp, torch.float64,
                                    "blockband", "cuda")
    st0 = pdlp.initial_state(dev, solver.hp, torch.float64)
    fn = pdlp.make_major_fn(solver.cfg)

    def timed(d, st):
        st, _ = fn(d, st)  # warm
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        st, rep = fn(d, st)
        e1.record()
        e1.synchronize()
        wall = time.perf_counter() - t0
        n = solver.hp.major_iteration
        return 1e3 * wall / n, e0.elapsed_time(e1) / n

    out = {"solo": timed(dev, st0)}
    for D in counts:
        mesh = make_mesh(devices=["cuda:0"] * D)
        sdev, sst = shard_problem_and_state(dev, st0, mesh)
        out[D] = timed(sdev, sst)

        def one_attempt(comm, d, st):
            d = attach_comm(d, comm)
            pdlp._attempt(d, st, solver.cfg, d.c - st.aty, st.step_size, 0)
            return comm.collectives, comm.bytes_sent

        per = run_spmd(mesh, one_attempt, list(zip(sdev.shards, sst.shards)))
        path = "halo" if sdev.shards[0].op.halo_meta is not None else \
            "general"
        log(f"[multi] {name}: {D} shard{'s' if D > 1 else ''} on 1 card "
            f"({path} path): {out[D][0]:.3f} ms wall, {out[D][1]:.3f} ms "
            f"CUDA events per step (unsharded {out['solo'][0]:.3f} / "
            f"{out['solo'][1]:.3f}); one attempt: {per[0][0]} collectives "
            f"per shard, {sum(b for _, b in per)} bytes exchanged")
        del sdev, sst


def phase_multi_f32_solve(p64, mesh):
    """staircase-64k in float32: the unsharded solve (every attempt through
    row_pass_atomic) and the same solve split over `mesh` (no row-pass
    launch), both OPTIMAL, objectives within 5e-4 relative, the sharded
    primal residual rechecked on the host in float64. Returns the
    unsharded solve's launch counts."""
    import torch

    from cuopt_torch import constants as C
    from cuopt_torch.lp.pdlp import PdlpSolver

    s = _settings(20000, operator_kind="blockband")
    sol, info, launches = _solve("staircase-64k", p64, s, ("row_pass_atomic",))
    require(sol.get_termination_reason() == "Optimal",
            "staircase-64k: unsharded float32 solve not OPTIMAL")
    want = sol.get_primal_objective()
    before = _row_pass_launches()
    t0 = time.perf_counter()
    raw = PdlpSolver(p64, s, "cuda", mesh=mesh).run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(_row_pass_launches() == before,
            "staircase-64k: the sharded solve launched a row-pass kernel")
    obj = raw["primal_objective"]
    rel = abs(obj - want) / abs(want)
    res, b_norm = host_primal_residual(p64, raw["primal_solution"])
    t = s.tolerances
    limit = t.absolute_primal_tolerance + t.relative_primal_tolerance * b_norm
    log(f"[multi] staircase-64k float32, {_mesh_label(mesh)}: status "
        f"{raw['status']}, {raw['iterations']} steps (unsharded "
        f"{info['iterations']}), objective {obj:.6f} (unsharded {want:.6f}, "
        f"rel {rel:.2e}), wall {wall:.3f} s (unsharded {info['wall_s']:.3f} "
        f"s), host float64 primal residual {res:.4e} (limit {limit:.4e})")
    require(raw["status"] == C.CUOPT_TERIMINATION_STATUS_OPTIMAL,
            f"staircase-64k sharded: status {raw['status']}")
    require(rel <= 5e-4, f"staircase-64k sharded: objective rel {rel:.2e}")
    require(res <= limit, f"staircase-64k sharded: residual {res} > {limit}")
    return launches


def phase_multi_frontier(p50, batch_sols, mesh):
    """Phase 11's eight members of staircase-50k by batch_solve over
    `mesh`: every member's status equal to phase 11's unsharded batch,
    its objective within 1e-6 and its attempts within 1%. (Each shard
    stacks two members where phase 11 stacked eight, and the stacked
    products round differently with the stack's size: on the card one
    member took 585 attempts sharded against 584 in phase 11; PERF.md,
    section 6.)"""
    import torch

    from cuopt_torch import batch_solve

    members = batch_members(p50)
    before = _row_pass_launches()
    t0 = time.perf_counter()
    sols = batch_solve(members, _f64_settings(), "cuda", mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(_row_pass_launches() == before,
            "frontier: the sharded batch launched a row-pass kernel")
    worst = 0.0
    attempts = []
    for k, (a, b) in enumerate(zip(sols, batch_sols)):
        ia = a.get_additional_termination_information()
        ib = b.get_additional_termination_information()
        rel = abs(a.get_primal_objective() - b.get_primal_objective()) / \
            abs(b.get_primal_objective())
        worst = max(worst, rel)
        attempts.append((ia["attempts"], ib["attempts"]))
        require(a.get_termination_reason() == b.get_termination_reason()
                == "Optimal", f"frontier member {k}: status")
        require(abs(ia["attempts"] - ib["attempts"]) <= 0.01 * ib["attempts"],
                f"frontier member {k}: {ia['attempts']} attempts sharded, "
                f"{ib['attempts']} in phase 11")
        require(rel <= 1e-6, f"frontier member {k}: objective rel {rel:.2e}")
    steps = sum(x.get_nb_iterations() for x in sols)
    same = sum(a == b for a, b in attempts)
    log(f"[multi] frontier staircase-50k x{len(members)}, "
        f"{_mesh_label(mesh)} ({len(members) // mesh.size} members a "
        f"shard): every member OPTIMAL as in phase 11, objectives within "
        f"{worst:.2e}, attempts (sharded, phase 11) {attempts}: {same} of "
        f"{len(attempts)} equal; wall {wall:.3f} s, {steps / wall:.1f} "
        f"member-steps/s")


def phase_multi_islands(mesh):
    """GHC_200_1's construction tiled into ISLANDS x MEMBERS members,
    EPOCHS epochs of SWEEP_STEPS sweep steps over `mesh`: each epoch's
    routes equal to a one-device simulation of it and costs within 1e-5;
    the best member serves every order once, keeps its time windows and
    capacity in a float64 host recheck, and costs no more than the
    construction. Returns the mean epoch wall in seconds."""
    import torch

    from cuopt_torch.io.vrp import synth_gh_instance
    from cuopt_torch.routing.construction import batched_construction
    from cuopt_torch.routing.internal import build_problem
    from cuopt_torch.routing.islands import (island_epoch,
                                             make_island_members,
                                             simulate_epoch)
    from cuopt_torch.routing.local_search import build_ls_problem

    inst = synth_gh_instance(200, "C", 1)
    prob = build_problem(inst.to_data_model())
    p = build_ls_problem(prob, device="cuda")
    # Solve's construction at this size (cheapest insertion leaves an
    # order out here)
    routes, unserved = batched_construction(prob, p)
    require(not unserved, f"islands: construction left {unserved}")
    F = prob.n_fleet
    L = max(8, max(len(r) for r in routes.values()) + 4)
    R0 = -np.ones((F, L), np.int64)
    lens0 = np.zeros(F, np.int64)
    for v, r in routes.items():
        R0[v, :len(r)] = r
        lens0[v] = len(r)
    base = sum(prob.route_cost(v, r) for v, r in routes.items() if r)
    Rs, lenss = make_island_members(prob, R0, lens0, ISLANDS * MEMBERS)
    Rs = torch.as_tensor(Rs, device="cuda")
    lenss = torch.as_tensor(lenss, device="cuda")
    before = _row_pass_launches()
    walls = []
    for e in range(EPOCHS):
        Rw, lw, cw, bw = simulate_epoch(p, Rs, lenss, ISLANDS, SWEEP_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Rs, lenss, costs, best = island_epoch(p, Rs, lenss, mesh, SWEEP_STEPS)
        best = float(best)
        walls.append(time.perf_counter() - t0)
        c = costs.cpu().numpy()
        differ = [k for k in range(len(c)) if not (
            np.array_equal(Rs[k].cpu().numpy(), Rw[k]) and
            np.array_equal(lenss[k].cpu().numpy(), lw[k]))]
        require(not differ,
                f"islands epoch {e}: members {differ} differ from the "
                f"simulation (costs {c[differ].tolist()} against "
                f"{cw[differ].tolist()}; all sharded {c.tolist()}, "
                f"simulated {cw.tolist()})")
        require(np.allclose(c, cw, rtol=1e-5, atol=0.0) and
                abs(best - bw) <= 1e-5 * abs(bw),
                f"islands epoch {e}: costs differ from the simulation")
        log(f"[multi] islands GHC_200_1 epoch {e}: best {best:.2f} "
            f"(construction {base:.2f}), wall {walls[-1]:.3f} s, equal to "
            f"the one-device simulation")
    require(_row_pass_launches() == before,
            "islands: an epoch launched a row-pass kernel")
    k = int(torch.argmin(costs))
    R, ln = Rs[k].cpu().numpy(), lenss[k].cpu().numpy()
    best_routes = [[int(o) for o in R[f, :ln[f]]] for f in range(F)]
    served = sorted(o for r in best_routes for o in r)
    tw_viol, cap_viol = host_route_check(inst, best_routes)
    log(f"[multi] islands GHC_200_1, {ISLANDS} islands x {MEMBERS} members "
        f"on {_mesh_label(mesh)}: best {best:.2f} with "
        f"{sum(1 for r in best_routes if r)} vehicles against construction "
        f"{base:.2f}; host float64 recheck: max time-window violation "
        f"{tw_viol:.3e}, max capacity excess {cap_viol:.3e}; epoch wall "
        f"{np.mean(walls):.3f} s mean")
    require(served == list(range(prob.n_serve)),
            "islands: the best member does not serve every order once")
    require(tw_viol <= 1e-6 and cap_viol <= 1e-9,
            "islands: the best member breaks a time window or capacity")
    require(best <= base + 1e-6, f"islands: best {best} above {base}")
    return float(np.mean(walls))


def phase_multi_mesh2d():
    """A 2 x 2 (slices, rows) mesh on the card: hierarchical_psum of 2^20
    float32 values against the flat sum, within 1e-6 relative."""
    import torch

    from cuopt_torch.parallel import hierarchical_psum, make_mesh_2d

    mesh2 = make_mesh_2d(2, 2, devices=["cuda:0"] * 4)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(1 << 20, generator=g, device="cuda")
    got, flat = float(hierarchical_psum(x, mesh2)), float(x.sum())
    rel = abs(got - flat) / abs(flat)
    log(f"[multi] hierarchical psum on 2 x 2 shards of the card: {got:.6f} "
        f"against the flat sum {flat:.6f} (rel {rel:.2e})")
    require(rel <= 1e-6, f"hierarchical psum rel {rel:.2e}")


def phase_multi_device(p50, batch_sols):
    """Phase 19: the mesh. Returns the row-pass launch counts of the
    unsharded float32 solve it holds the sharded one against."""
    import torch

    from cuopt_torch.parallel import make_mesh

    meshes = [make_mesh(devices=["cuda:0"] * 4)]
    if torch.cuda.device_count() > 1:
        meshes.append(make_mesh())
    p64 = staircase(HALO_N)
    for mesh in meshes:
        op = sharded_majors_check("staircase-64k", p64, mesh)
        require(op.halo_meta is not None,
                "staircase-64k: the halo extension was not built")
        torch.cuda.empty_cache()
        op = sharded_majors_check("staircase-50k", p50, mesh)
        require(op.halo_meta is None and op.row_halo is None,
                "staircase-50k: expected the general path")
        torch.cuda.empty_cache()
    sharded_step_times("staircase-64k", p64)
    launches = phase_multi_f32_solve(p64, meshes[0])
    del p64
    torch.cuda.empty_cache()
    for mesh in meshes:
        phase_multi_frontier(p50, batch_sols, mesh)
    phase_multi_islands(meshes[0])
    phase_multi_mesh2d()
    return launches


# ----------------------------------------------------------- phase 20
REROUTE_LIMIT, OBJ_LIMIT = 10, 6  # seconds of each routing Solve
NEW_PAIRS, CHAINS = 10, 20


def gh200_pd():
    """GHC_200_1 (synth_gh_instance(200, "C", 1)) as pickup-delivery
    pairs: order i with i + 100, the delivery's demand minus the
    pickup's (gh60's "pd" variant), every order's window [0, the depot's
    close], the instance's service times (tests/torch_routing_instances.py
    pd_wide)."""
    from cuopt_torch.io.vrp import synth_gh_instance

    inst = synth_gh_instance(200, "C", 1)
    d = inst.demand.copy()
    d[101:] = -d[1:101]
    inst.demand = d
    inst.tw_early = np.zeros_like(inst.tw_early)
    inst.tw_late = np.full_like(inst.tw_late, inst.tw_late[0])
    dm = inst.to_data_model()
    dm.set_pickup_delivery_pairs(np.arange(100), np.arange(100, 200))
    return dm


def gh200_chains(inst=None):
    """GHC_200_1 with CHAINS seeded precedence chains of three orders,
    each chain ordered by the orders' windows: (DataModel, links)."""
    from cuopt_torch.io.vrp import synth_gh_instance

    inst = inst or synth_gh_instance(200, "C", 1)
    dm = inst.to_data_model()
    rng = np.random.default_rng(21)
    links = []
    for chain in rng.choice(200, (CHAINS, 3), replace=False):
        a, b, c = sorted(chain.tolist(),
                         key=lambda o: (inst.tw_early[o + 1], o))
        dm.add_order_precedence(b, [a])
        dm.add_order_precedence(c, [b])
        links += [(a, b), (b, c)]
    return dm, links


def counted_solve(dm, limit, device):
    """The routing Solve of `dm` for `limit` s, seed 0, with what it did:
    (solution, wall seconds, {"checked", "passed": the local search's host
    rechecks of device moves (_ls_recheck_stats on the solve's problem),
    "children": the diversity loop's children (the local-search passes
    less the two before the loop)}). It reads them through
    solver.build_problem and solver._local_search, which every version
    of the port has, so that scripts/torch_pd_recheck.py counts a parent
    checkout's solve the same way."""
    from cuopt_torch.routing import Solve
    from cuopt_torch.routing import solver as rs

    probs, passes = [], [0]
    build, search = rs.build_problem, rs._local_search

    def counting(*args, **kw):
        passes[0] += 1
        return search(*args, **kw)

    rs.build_problem = lambda d: probs.append(build(d)) or probs[-1]
    rs._local_search = counting
    try:
        t0 = time.perf_counter()
        sol = Solve(dm, _routing_settings(limit), device=device)
        wall = time.perf_counter() - t0
    finally:
        rs.build_problem, rs._local_search = build, search
    checked, passed = getattr(probs[-1], "_ls_recheck_stats", (0, 0))
    return sol, wall, dict(checked=checked, passed=passed,
                           children=max(passes[0] - 2, 0))


def _order_rows(table):
    """{vehicle: [(order, arrival), ...] in arrival order} of a route
    table's order rows."""
    kind = np.asarray(table["type"], object)
    rows = np.flatnonzero((kind == "Pickup") | (kind == "Delivery"))
    out = {}
    for i in rows[np.argsort(table["arrival_stamp"][rows], kind="stable")]:
        out.setdefault(int(table["truck_id"][i]), []).append(
            (int(table["route"][i]), float(table["arrival_stamp"][i])))
    return out


def host_model_check(dm, table):
    """Recheck a solve of the routing DataModel `dm` on the host in
    float64, from dm's own arrays: (orders served not exactly once, max
    time-window violation, max capacity excess of a route's demand, max
    excess of the load carried after a stop, pairs broken (split over
    vehicles or delivery first), orders off their pinned vehicle, COST
    and TRAVEL_TIME of the routes). For pickup-delivery pairs the summed
    demand is the net load; the port holds the load carried after every
    stop (internal.py route_feasible; cuopt_tpu holds the net load), and
    the smoke requires both. Each vehicle leaves its start at its
    window's opening, waits for an order's window to open and returns to
    its return location."""
    loc = np.asarray(dm.order_locations)
    early, late = (np.asarray(a, float) for a in dm.order_tw)
    svc = dm.order_service_times.get(-1, np.zeros(len(loc)))
    (demand, cap), = dm.capacity_dimensions.values()
    T = next(iter((dm.transit_time_matrices or dm.cost_matrices).values()))
    C = next(iter(dm.cost_matrices.values()))
    F = dm.n_fleet
    v_early, v_late = (np.zeros(F), np.full(F, np.inf)) \
        if dm.vehicle_tw is None else \
        (np.asarray(a, float) for a in dm.vehicle_tw)
    start = np.zeros(F, int) if dm.vehicle_start is None \
        else dm.vehicle_start
    ret = np.zeros(F, int) if dm.vehicle_return is None \
        else dm.vehicle_return
    routes = _order_rows(table)
    seen = np.zeros(len(loc), int)
    tw_viol = cap_viol = carried = cost = travel = 0.0
    where = {}
    for v, rows in routes.items():
        t, at, load = v_early[v], int(start[v]), 0.0
        for k, (o, _) in enumerate(rows):
            seen[o] += 1
            where[o] = (v, k)
            cost += C[at, loc[o]]
            t = max(t + T[at, loc[o]], early[o])
            tw_viol = max(tw_viol, t - late[o])
            t += svc[o]
            at = int(loc[o])
            load += demand[o]
            carried = max(carried, load - cap[v])
        cap_viol = max(cap_viol, load - cap[v])
        back = int(ret[v])
        cost += C[at, back]
        t += T[at, back]
        tw_viol = max(tw_viol, t - v_late[v])
        travel += t - v_early[v]
    broken = 0
    if dm.pickup_indices is not None:
        for p, d in zip(dm.pickup_indices, dm.delivery_indices):
            (vp, kp), (vd, kd) = where.get(p, (-1, 0)), where.get(d, (-2, 0))
            broken += vp != vd or kp >= kd
    off = sum(where.get(o, (-1,))[0] not in set(map(int, vs))
              for o, vs in dm.order_vehicle_match.items())
    return dict(not_once=int(np.sum(seen != 1)), tw_viol=tw_viol,
                served=set(np.flatnonzero(seen).tolist()),
                cap_viol=cap_viol, carried=carried, broken_pairs=broken,
                off_pin=off,
                cost=cost, travel=travel)


def _check_routes(name, dm, sol, wall, unserved_ok=False):
    """Status 0 and the host recheck of host_model_check. With
    `unserved_ok`, status 1 passes too where the orders left out are
    exactly those the solve reports undeliverable."""
    chk = host_model_check(dm, sol.get_route())
    unserved = sorted(map(int, sol.get_infeasible_orders()))
    if unserved_ok and sol.get_status() == 1:
        missing = [o for o in range(dm.get_num_orders())
                   if o not in chk["served"]]
        log(f"[phase20] {name}: {len(unserved)} orders reported "
            f"undeliverable ({sol.get_message()})")
        require(missing == unserved,
                f"{name}: orders left out are not those reported")
        chk["not_once"] -= len(unserved)
    else:
        require(sol.get_status() == 0, f"{name}: status "
                f"{sol.get_status()} ({sol.get_message()})")
    log(f"[phase20] {name}: {sol.get_vehicle_count()} vehicles, cost "
        f"{chk['cost']:.2f}, wall {wall:.2f} s; host float64 recheck: "
        f"{chk['not_once']} orders not served once, {chk['broken_pairs']} "
        f"pairs broken, {chk['off_pin']} orders off their vehicle, max "
        f"time-window violation {chk['tw_viol']:.3e}, max capacity excess "
        f"{chk['cap_viol']:.3e} (of the load carried after a stop: "
        f"{chk['carried']:.3e})")
    require(chk["not_once"] == 0, f"{name}: an order not served once")
    require(chk["broken_pairs"] == 0,
            f"{name}: a pair split or delivered before its pickup")
    require(chk["off_pin"] == 0, f"{name}: an order off its vehicle")
    require(chk["tw_viol"] <= 1e-6 and chk["cap_viol"] <= 1e-9,
            f"{name}: a route breaks its time windows or capacity")
    require(chk["carried"] <= 1e-9,
            f"{name}: a route carries more than its capacity after a stop")
    return chk


def _pair_moves_on_card(dm, table, device):
    """The local search's move scores of the pickup-delivery routes in
    `table` (the port's carried-load path: peaks from the running load,
    Or-opt moving a pickup with its adjacent delivery) on `device` and on
    the CPU: every score tensor finite at the same entries, deltas within
    1e-3. Every pair relocate the card scores as feasible, applied on the
    host, leaves both routes within their capacity after every stop, each
    pickup before its delivery. Returns (finite moves, pair relocates)."""
    from cuopt_torch.routing import local_search as ls
    from cuopt_torch.routing.internal import build_problem
    from cuopt_torch.routing.solver import (
        _apply_move,
        _pad_len,
        _routes_to_arrays,
    )

    prob = build_problem(dm)
    require(np.array_equal(prob.serve_orders, np.arange(prob.n_serve)),
            "pair moves: serve indices are not the order ids")
    routes = {v: [] for v in range(prob.n_fleet)}
    for v, rows in _order_rows(table).items():
        routes[v] = [o for o, _ in rows]
    R, lens = _routes_to_arrays(prob, routes, _pad_len(routes, headroom=12))
    scores = []
    for dev in (device, "cpu"):
        lsp = ls.build_ls_problem(prob, device=dev)
        require(lsp.has_pairs, "pair moves: the problem has no pairs")
        scores.append([ls.to_host(x) for x in ls._move_scores(
            lsp, ls._ids(lsp, R), ls._ids(lsp, lens))])
    live = 0
    for x, y in zip(*scores):
        fx, fy = x < ls.BIG / 2, y < ls.BIG / 2
        require(np.array_equal(fx, fy) and np.allclose(
            x[fx], y[fy], rtol=1e-5, atol=1e-3),
            f"pair moves: {device} and the CPU disagree")
        live += int(fx.sum())

    def carried_ok(v, r):
        load = np.cumsum(prob.demand[:, r], axis=1)
        pos = {o: k for k, o in enumerate(r)}
        return bool(np.all(load <= prob.capacity[:, v, None] + 1e-9)) and \
            all(pos.get(int(prob.pd_partner[o]), -1) > k
                for k, o in enumerate(r) if prob.pd_sign[o] > 0)

    pairs = 0
    for f2, j, f1, i in np.argwhere(scores[0][4] < ls.BIG / 2):
        if prob.pd_partner[R[f1, i]] != R[f1, i + 1]:
            continue
        pairs += 1
        new = _apply_move({v: list(r) for v, r in routes.items()}, 4,
                          (f2, j, f1, i))
        require(carried_ok(int(f1), new[int(f1)]) and
                carried_ok(int(f2), new[int(f2)]),
                f"pair moves: relocate {(f2, j, f1, i)} breaks the "
                f"carried load")
    return live, pairs


def _routing_settings(limit):
    from cuopt_torch.routing import SolverSettings

    s = SolverSettings()
    s.time_limit = limit
    s.seed = 0
    return s


def phase_reroute(device="cuda"):
    """GHC_200_1 as pickup-delivery pairs solved for REROUTE_LIMIT s, then
    re-routed at half its largest arrival stamp with NEW_PAIRS seeded new
    pairs and the new model solved for REROUTE_LIMIT s. Each order of the
    re-routed model is what the first plan left: the pairs not finished
    by then, a dummy pickup where only the pickup was made, and the new
    pairs."""
    from cuopt_torch.routing import Solve, construct_rerouting_model

    dm = gh200_pd()
    sol, wall, st = counted_solve(dm, REROUTE_LIMIT, device)
    _check_routes("GHC_200_1-pd", dm, sol, wall)
    log(f"[phase20] GHC_200_1-pd: the local search's host recheck took "
        f"{st['checked']} device moves, passed {st['passed']} on cost and "
        f"feasibility ({st['checked'] - st['passed']} rejected); "
        f"{st['children']} children in the diversity loop")
    t0 = time.perf_counter()
    live, pairs = _pair_moves_on_card(dm, sol.get_route(), device)
    log(f"[phase20] GHC_200_1-pd: move scores of its routes on {device} "
        f"equal to the CPU's ({live} feasible moves, {pairs} pair "
        f"relocates, each within the carried load on the host) in "
        f"{time.perf_counter() - t0:.2f} s")
    table = sol.get_route()
    t_mid = 0.5 * float(table["arrival_stamp"].max())
    rng = np.random.default_rng(20)
    close = float(dm.vehicle_tw[1][0])
    size = rng.integers(1, 41, NEW_PAIRS).astype(float)
    new = dict(
        order_locations=rng.integers(1, 201, 2 * NEW_PAIRS).tolist(),
        earliest_time=[t_mid] * (2 * NEW_PAIRS),
        latest_time=[close] * (2 * NEW_PAIRS),
        service_time=[10.0] * (2 * NEW_PAIRS),
        pickup_indices=list(range(NEW_PAIRS)),
        delivery_indices=list(range(NEW_PAIRS, 2 * NEW_PAIRS)),
        demand=np.concatenate([size, -size]).tolist())
    t0 = time.perf_counter()
    new_dm, order_map = construct_rerouting_model(dm, table, t_mid, new)
    build = time.perf_counter() - t0
    # what the first plan leaves at t_mid, from its table alone
    done = {o for rows in _order_rows(table).values()
            for o, t in rows if t <= t_mid}
    carrier = {o: v for v, rows in _order_rows(table).items()
               for o, _ in rows}
    want = [("new", i) for i in range(2 * NEW_PAIRS)]
    for p, d in zip(range(100), range(100, 200)):
        if p in done and d not in done:
            want += [("dummy", p), d]
        elif p not in done:
            want += [p, d]
    got = list(order_map.values())
    partial = sum(isinstance(x, tuple) and x[0] == "dummy" for x in got)
    log(f"[phase20] re-route at {t_mid:.2f}: {len(got)} orders ({partial} "
        f"dummy pickups, {2 * NEW_PAIRS} new), model built in "
        f"{1e3 * build:.1f} ms")
    require(sorted(map(str, got)) == sorted(map(str, want)),
            "re-route: the model's orders are not the unfinished and new")
    for k, x in order_map.items():
        if isinstance(x, tuple) and x[0] == "dummy":
            require(new_dm.order_vehicle_match[k].tolist() ==
                    [carrier[x[1]]],
                    f"re-route: dummy pickup of {x[1]} not pinned to its "
                    f"carrier")
    t0 = time.perf_counter()
    sol2 = Solve(new_dm, _routing_settings(REROUTE_LIMIT), device=device)
    _check_routes("GHC_200_1-pd re-routed", new_dm, sol2,
                  time.perf_counter() - t0)


def phase_objectives(device="cuda"):
    """GHC_200_1 solved under the weights [COST, TRAVEL_TIME] = [1, 0.5]:
    the reported COST and TRAVEL_TIME equal the host's recomputation from
    the routes within 1e-9, the total their weighted sum. Then with
    CHAINS seeded precedence chains of three orders (each chain ordered by
    the orders' windows): every link kept on the routes' arrival stamps."""
    from cuopt_torch.io.vrp import synth_gh_instance
    from cuopt_torch.routing import Objective, Solve

    inst = synth_gh_instance(200, "C", 1)
    dm = inst.to_data_model()
    dm.set_objective_function([Objective.COST, Objective.TRAVEL_TIME],
                              [1.0, 0.5])
    t0 = time.perf_counter()
    sol = Solve(dm, _routing_settings(OBJ_LIMIT), device=device)
    chk = _check_routes("GHC_200_1 [COST, TRAVEL_TIME]", dm, sol,
                        time.perf_counter() - t0)
    vals = sol.get_objective_values()
    rel = [abs(vals[Objective.COST] - chk["cost"]) / chk["cost"],
           abs(vals[Objective.TRAVEL_TIME] - chk["travel"]) / chk["travel"]]
    total = chk["cost"] + 0.5 * chk["travel"]
    rel.append(abs(sol.get_total_objective() - total) / total)
    log(f"[phase20] objectives: COST {vals[Objective.COST]:.6f} (host "
        f"{chk['cost']:.6f}), TRAVEL_TIME {vals[Objective.TRAVEL_TIME]:.6f} "
        f"(host {chk['travel']:.6f}), total {sol.get_total_objective():.6f}"
        f" (host {total:.6f}); largest relative gap {max(rel):.2e}")
    require(max(rel) <= 1e-9, "objectives: reported values off the routes")

    dm, links = gh200_chains(inst)
    sol, wall, st = counted_solve(dm, OBJ_LIMIT, device)
    # some orders of these chains may stay unserved: the solve must say
    # which, and keep every link it serves
    _check_routes(f"GHC_200_1 + {CHAINS} precedence chains", dm, sol,
                  wall, unserved_ok=True)
    log(f"[phase20] precedence: {len(sol.get_infeasible_orders())} of 200 "
        f"orders undeliverable after {OBJ_LIMIT} s (7 on the card before "
        f"unserved successors were reinserted), {st['children']} children "
        f"in the diversity loop")
    arr = {o: t for rows in _order_rows(sol.get_route()).values()
           for o, t in rows}
    late = [(a, b) for a, b in links if b in arr and
            (a not in arr or arr[b] < arr[a] - 1e-9)]
    log(f"[phase20] precedence: {len(links)} links, "
        f"{sum(a in arr and b in arr for a, b in links)} with both orders "
        f"served, {len(late)} broken (a successor served before its "
        f"predecessor, or without it)")
    require(not late, f"precedence: links {late[:5]} broken")


def unnamed_twelve():
    """Phase 12's twelve binaries, column 3 fixed to 1 by its bounds, as
    (named from_dense problem, the same built field by field without
    names)."""
    from cuopt_torch.problem.data_model import OptimizationProblem

    p = twelve_binaries()
    p.variable_lower_bounds[3] = p.variable_upper_bounds[3] = 1.0
    u = OptimizationProblem(**{k: np.copy(v) for k, v in dict(
        offsets=p.offsets, indices=p.indices, values=p.values,
        objective_coefficients=p.objective_coefficients,
        constraint_lower_bounds=p.constraint_lower_bounds,
        constraint_upper_bounds=p.constraint_upper_bounds,
        row_types=p.row_types, rhs=p.rhs,
        variable_lower_bounds=p.variable_lower_bounds,
        variable_upper_bounds=p.variable_upper_bounds,
        variable_types=p.variable_types).items()})
    return p, u


def phase_unnamed_mip(device="cuda"):
    """solve_mip on the unnamed twelve binaries with a fixed column (its
    presolve drops that column): the named problem's status, objective
    and point."""
    from cuopt_torch import solve_mip

    p, u = unnamed_twelve()
    require(u.variable_names == [], "unnamed MIP: it has names")
    best = brute_force_min(p)
    a = solve_mip(p, _mip_settings(60.0), device=device)
    t0 = time.perf_counter()
    b = solve_mip(u, _mip_settings(60.0), device=device)
    wall = time.perf_counter() - t0
    log(f"[phase20] unnamed twelve binaries, column 3 fixed: "
        f"{b.get_termination_reason()}, objective "
        f"{b.get_primal_objective()} (named {a.get_primal_objective()}, "
        f"brute force {best}), wall {wall:.3f} s")
    require(a.get_termination_reason() == "Optimal" and
            b.get_termination_reason() == "Optimal",
            "unnamed MIP: not OPTIMAL")
    require(b.get_primal_objective() == a.get_primal_objective() == best,
            "unnamed MIP: objective")
    require(np.array_equal(b.get_primal_solution(),
                           a.get_primal_solution()), "unnamed MIP: point")


def phase_parity(device="cuda"):
    """Phase 20: re-routing, objectives and precedence on GHC_200_1, and an
    unnamed MIP, on the card."""
    t0 = time.perf_counter()
    phase_reroute(device)
    phase_objectives(device)
    phase_unnamed_mip(device)
    log(f"[phase20] wall {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------ phase 21
def _run_bench(name, args, timeout):
    """Run a bench script of the port as a process from the checkout's
    root; returns its last line as JSON after requiring exit code 0."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    require(out.returncode == 0,
            f"{name}: exit {out.returncode}: {out.stderr[-2000:]}")
    line = out.stdout.strip().splitlines()[-1]
    log(f"[bench] {name}: {wall:.1f} s: {line}")
    return json.loads(line)


def phase_benches():
    """Phase 21: bench_torch.py and the routing bench on GHC_200_1, as a
    user runs them. Returns bench_torch's launches per kernel, summed
    over its two instances."""
    import math

    line = _run_bench("bench_torch.py", ["bench_torch.py"], 600)
    require(line["metric"] == "pdhg_iters_per_s_synth50k_geomean",
            f"bench_torch.py: metric {line['metric']}")
    d = line["detail"]
    for k in ("staircase_iters_per_s", "shuffled_unstructured_iters_per_s"):
        require(math.isfinite(d[k]) and d[k] > 0, f"bench_torch.py: {k}")
    for inst, counts in d["launches"].items():
        require(counts["row_pass_atomic"] > 0,
                f"bench_torch.py: {inst} never launched row_pass_atomic")
    bks = _run_bench("torch_bks_benchmark.py GHC_200_1", [
        "scripts/torch_bks_benchmark.py", "--instances", "GHC_200_1",
        "--time-limit", "10"], 300)
    require(bks["solved"] == bks["total"] == 1,
            "torch_bks_benchmark.py: GHC_200_1 not solved with every "
            "order once and its routes kept")
    return Counter({k: sum(c[k] for c in d["launches"].values())
                    for k in next(iter(d["launches"].values()))})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import cuopt_torch  # noqa: F401  (fails outside a checkout)
    from cuopt_torch.lp import pdhg_fused as pf
    from cuopt_torch.lp import pdhg_step as ps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_device()
    p50 = staircase(50_000)
    p50s = shuffled(p50)
    p300 = staircase(300_000)
    pd = degen_transport()
    ops = {
        "staircase-50k": band_operator(p50, "blockband"),
        "shuffled-50k": band_operator(p50s, "bandperm"),
        "degen-transport-100k": band_operator(pd, "bandperm"),
        "staircase-300k": band_operator(p300, "blockband"),
    }
    records = phase_kernels(ops)
    del ops
    torch.cuda.empty_cache()
    records.update(phase_step_kernels({50_000: p50, 300_000: p300}))
    log(f"[kernels] done at {time.perf_counter() - t_start:.1f} s")

    total = Counter()  # launches over every solve of the main path
    rates = {}
    for name, prob, n, kernels in (
            ("staircase-50k", p50, 50_000, ("row_pass_atomic",)),
            ("shuffled-50k", p50s, 50_000, ("row_pass_atomic",)),
            ("staircase-300k", p300, 300_000, ("row_pass_partials",))):
        launches, info = phase_solve(name, prob, n, kernels)
        total.update(launches)
        rates[name] = info["loop_steps"] / info["solve_loop_s"]
        log(f"[solve] {name} done at {time.perf_counter() - t_start:.1f} s")
    total.update(phase_f64_solve(p50))
    log(f"[solve] staircase-50k float64 done at "
        f"{time.perf_counter() - t_start:.1f} s")
    total.update(phase_degen_solve(pd))
    log(f"[solve] degen-transport-100k done at "
        f"{time.perf_counter() - t_start:.1f} s")

    p2k = staircase(2000)
    highs_2k = highs_objective(p2k)
    total.update(phase_concurrent(p50, p2k, highs_2k, rates["staircase-50k"]))
    log(f"[concurrent] done at {time.perf_counter() - t_start:.1f} s")
    total.update(phase_crossover(p2k, highs_2k))
    log(f"[crossover] done at {time.perf_counter() - t_start:.1f} s")
    total.update(phase_warm_start(p50))
    log(f"[warm start] done at {time.perf_counter() - t_start:.1f} s")
    for k in (*pf.KERNELS, *ps.KERNELS):
        require(total[k.name] > 0,
                f"{k.name} was never launched on the main path")

    # six majors each: the profiler's own processing took about 2 min of
    # host time over the full solves, and the per-step figures do not
    # need them
    phase_profile("staircase-50k", p50, PROFILE_STEPS)
    phase_profile("staircase-300k", p300, PROFILE_STEPS)
    phase_profile("degen-transport-100k", pd, PROFILE_STEPS)
    log(f"[profile] done at {time.perf_counter() - t_start:.1f} s")
    del p300, pd, p50s
    torch.cuda.empty_cache()

    # phases 11-14 run in float64: the row-pass kernels (float32) see no
    # launch there, the step kernels one an attempt of each solo PDLP
    # solve of the MIPs, and the counts go on adding up
    reset_counts()
    batch_sols = phase_batch("staircase-50k x8", p50, "blockband")
    # Batched and alone, a dense-1k member's iterates part in their last
    # bits (other kernels sum in other orders) and drift apart over its
    # ~13 majors: the two runs can stop a major apart, or in one major at
    # two 1e-4 points more than 1e-6 apart (PERF.md, section 6). So here the
    # end is held to the solves' own tolerance and to each member being
    # nearest its own solo run, and the trajectory to the per-major check
    # of batch_majors_check
    phase_batch("dense-1k x8", staircase(1000), "dense", obj_rtol=1e-4,
                steps_rtol=None)
    log(f"[batch] done at {time.perf_counter() - t_start:.1f} s")
    phase_exact_mips()
    log(f"[mip] exact MIPs done at {time.perf_counter() - t_start:.1f} s")
    n13 = simplex_root_size()
    p13, x13 = staircase_mip(n13)
    sol13 = phase_mip(f"staircase-mip-{n13 // 1000}k", p13, x13, 30.0,
                      {"root_lp": "dual_simplex", "node_lp": "dual_simplex"})
    # within strengthen_root's gate a cut round starts; whether it ends
    # inside its simplex cap is printed with the tree's mip_stats
    if n13 * 2 * n13 <= 3e7:
        require(sol13._raw["mip_stats"]["cut_rounds"] >= 1,
                "staircase-mip: no cut round")
    log(f"[mip] staircase-mip-{n13 // 1000}k done at "
        f"{time.perf_counter() - t_start:.1f} s")
    p14, x14 = staircase_mip(50_000)
    phase_mip("staircase-mip-50k", p14, x14, 60.0,
              {"root_lp": "pdlp", "node_lp": "pdlp"})
    phase_fj_chunk("staircase-mip-50k", p14)
    log(f"[mip] staircase-mip-50k done at "
        f"{time.perf_counter() - t_start:.1f} s")
    total.update(launch_counts())
    del p14, x14, p13, x13
    torch.cuda.empty_cache()

    # routing reaches no row-pass kernel: the counts stay as they were
    before = {k.name: k.launches for k in pf.KERNELS}
    phase_routing_gh200()
    log(f"[routing] GHC_200_1 done at {time.perf_counter() - t_start:.1f} s")
    phase_routing_4k()
    log(f"[routing] routing-4k-RC7 done at "
        f"{time.perf_counter() - t_start:.1f} s")
    require("pandas" not in sys.modules, "the routing phases loaded pandas")
    require(all(k.launches == before[k.name] for k in pf.KERNELS),
            "the routing phases launched a row-pass kernel")

    # phases 17-18: the surface (its facade solve launches the row pass;
    # the CLI, the C ABI and the service solve in float64 and launch
    # none) and the solver service, in processes of their own
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        total.update(phase_surface(p50, p2k, highs_2k, workdir))
        log(f"[surface] done at {time.perf_counter() - t_start:.1f} s")
        phase_service(p50, workdir)
        log(f"[service] done at {time.perf_counter() - t_start:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # phase 19: the mesh, four shards on the card; its unsharded float32
    # reference solve launches row_pass_atomic, the sharded runs none
    total.update(phase_multi_device(p50, batch_sols))
    log(f"[multi] done at {time.perf_counter() - t_start:.1f} s")

    # phase 20: routing and float64 MIP work, no row-pass launch
    before = {k.name: k.launches for k in pf.KERNELS}
    phase_parity()
    log(f"[phase20] done at {time.perf_counter() - t_start:.1f} s")
    require("pandas" not in sys.modules, "phase 20 loaded pandas")
    require(all(k.launches == before[k.name] for k in pf.KERNELS),
            "phase 20 launched a row-pass kernel")

    # phase 21: the benches, in processes of their own with their own
    # counts
    bench_launches = phase_benches()
    log(f"[phase21] done at {time.perf_counter() - t_start:.1f} s")

    # each kernel at the shapes the main path gives it
    shape_of = {"row_pass_atomic": "staircase-50k",
                "row_pass_partials": "staircase-300k",
                "pdhg_primal": "staircase-50k",
                "pdhg_dual": "staircase-50k-f64",
                "pdhg_row_sums": "staircase-50k",
                "pdhg_commit": "staircase-50k"}
    kernels = []
    for k in pf.KERNELS:
        rec = records[(shape_of[k.name], k.name)]
        kernels.append({
            "name": k.name, "route": "cuda",
            "source": f"cuopt_torch/csrc/{k.source}.cu",
            "replaces": k.replaces, "launches": total[k.name],
            "bench_launches": bench_launches[k.name],
            "shape": shape_of[k.name],
            **rec,
            # the same kernel at the main path's widest window
            "degen_transport_100k": records[("degen-transport-100k",
                                             k.name)],
        })
    for k in ps.KERNELS:
        kernels.append({
            "name": k.name, "route": "cuda",
            "source": f"cuopt_torch/csrc/{k.source}.cu",
            "replaces": k.replaces, "launches": total[k.name],
            # bench_torch.py counts the row pass's launches only
            "bench_launches": None,
            "shape": shape_of[k.name],
            **records[(shape_of[k.name], k.name)],
            # the same kernel in the other cases that run it
            "cases": {case: records[(case, k.name)]
                      for case, _, _ in STEP_CASES
                      if case != shape_of[k.name]
                      and (case, k.name) in records},
        })
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
