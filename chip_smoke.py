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
     50 calls captured in a CUDA graph (no host launch cost);
  3-5. solve_lp by PDLP alone in float32 on the 50k staircase, its
     shuffled copy and the 300k staircase: OPTIMAL, objective within 1e-3
     relative of scipy's HiGHS, the primal residual rechecked on the host
     in float64, and every step attempt launched through the row-pass
     kernels;
  6. solve_lp in float32 on degen-transport at scale 100,000, which PDLP
     does not solve in reasonable time, to a fixed 400 steps:
     ITERATION_LIMIT, finite iterates, every attempt through the
     column-split body of row_pass_partials;
  7. concurrent (the default method: the host dual simplex races PDLP):
     PDLP wins the 50k staircase in float32 through row_pass_atomic and
     the simplex thread is halted and joined; the simplex wins the 2k
     staircase inside the grace poll, to HiGHS's optimum within 1e-9; the
     50k staircase under PDLPSolverSettings() defaults (float64);
  8. crossover: PDLP in float32 on the 2k staircase, then the simplex
     from its point to HiGHS's vertex within 1e-9, in fewer pivots than
     a cold simplex;
  9. warm start: the 50k staircase re-solved from a first solve's state
     after its objective is scaled by 1 + 1e-3, in fewer steps than a
     cold re-solve, every attempt through row_pass_atomic;
  10. profile: the 50k, the 300k and the degen-transport solves once more
     under torch.profiler, for the device's busy time, its idle share,
     the row pass's share of device time and the kernels that take the
     most device time.

The last two lines are one JSON object with every kernel's launches,
error and times, and the contract line
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
import time
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
# PDLP's optimality tolerance before crossover (phase_crossover). On the
# CPU, from ten float32 PDLP points of the 2k staircase each (different
# starting points), the shared C++ crossover crashed on 8 at 1e-4 and on
# none at 5e-5, 2e-5 or 1e-5, with 84 pivots from every 1e-5 point
# (scripts/torch_crossover_crashes.py).
CROSSOVER_TOL = 1e-5

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
    with ThreadPoolExecutor(2) as pool:
        cuda_build = pool.submit(BUILDER.build, "row_pass")
        host_build = pool.submit(BUILDER.build_simplex)
        built, simplex_built = cuda_build.result(), host_build.result()

    def took(s):
        return "cached" if s is None else f"{s:.2f} s"

    log(f"build: {time.perf_counter() - t0:.2f} s wall, row_pass (nvcc) "
        f"{took(built)}, simplex (g++) {took(simplex_built)}")
    for name, out in BUILDER.log.items():
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


def _solve(name, prob, s, kernels):
    """solve_lp in float32 on the card with the launch counts reset just
    before it; prints its status, steps, loop rate and launches and checks
    that each attempt went through `kernels` and never through the plain
    version. Returns (solution, info, launch counts)."""
    import torch

    from cuopt_torch.lp import pdhg_fused as pf
    from cuopt_torch.lp.solve import solve_lp

    torch.cuda.reset_peak_memory_stats()
    pf.reset_counts()
    t0 = time.perf_counter()
    sol = solve_lp(prob, s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in pf.KERNELS}
    plain = pf.PlainCount.calls
    info = sol.get_additional_termination_information()
    info["wall_s"] = wall
    steps, attempts = info["iterations"], info["attempts"]
    loop_s = info["solve_loop_s"]
    dev = getattr(prob, "_cuopt_torch_device_cache", (None, None))[1]
    op = dev.op if dev is not None else None
    slab_bytes = op.row_slabs.numel() * 4 if hasattr(op, "row_slabs") \
        else None
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
    for k in kernels:
        require(launches[k] == attempts,
                f"{name}: {k} launched {launches[k]} times for {attempts} "
                f"step attempts")
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


# ------------------------------------------------------------ phase 6
def degen_transport():
    from cuopt_torch.problem.mittelmann import GENERATORS

    return GENERATORS["degen-transport"](100_000, 0)


def phase_degen_solve(prob):
    """degen-transport-100k to DEGEN_STEPS steps: ITERATION_LIMIT, finite
    iterates, every attempt through row_pass_partials. Returns the
    kernels' launch counts of this solve."""
    sol, info, launches = _solve("degen-transport-100k", prob,
                                 _settings(DEGEN_STEPS),
                                 ("row_pass_partials",))
    # the layout's price: the slabs against a float32 CSR copy (values,
    # int32 column indices and row offsets)
    n_slab = prob._cuopt_torch_device_cache[1].op.row_slabs.numel()
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
    import threading

    from cuopt_torch.dual_simplex.concurrent import SIMPLEX_THREAD

    left = [t for t in threading.enumerate() if t.name == SIMPLEX_THREAD]
    require(not left, f"{name}: a simplex thread outlived the race")


def phase_concurrent(p50, p2k, highs_2k, alone_rate):
    """The default method, Concurrent: the host dual simplex races PDLP.
    (a) staircase-50k in float32: PDLP wins through row_pass_atomic, the
    simplex is halted and joined; its loop rate beside the PDLP-alone rate
    of phase 3. (b) the 2k staircase: the simplex wins inside the grace
    poll, to HiGHS's optimum within 1e-9. (c) staircase-50k under
    PDLPSolverSettings() defaults (float64, the unfused step). Returns the
    kernels' launch counts over the three solves."""
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
    pf.reset_counts()
    t0 = time.perf_counter()
    sol = solve_lp(p2k, _settings(20000, method=C.CUOPT_METHOD_CONCURRENT))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    info = sol.get_additional_termination_information()
    _race_line(name, info, wall)
    obj = sol.get_primal_objective()
    rel = abs(obj - highs_2k) / abs(highs_2k)
    launches = {k.name: k.launches for k in pf.KERNELS}
    total.update(launches)
    log(f"[concurrent] {name}: objective {obj:.12f} (HiGHS {highs_2k:.12f}, "
        f"rel err {rel:.2e}), launches {launches}")
    require(sol.get_termination_reason() == "Optimal", f"{name}: status")
    require(info["solved_by"] == "dual_simplex",
            f"{name}: {info['solved_by']} won")
    require(rel <= 1e-9, f"{name}: objective {obj} vs HiGHS {highs_2k}")
    _no_simplex_thread_left(name)

    name = "concurrent staircase-50k float64 defaults"
    s = PDLPSolverSettings()
    s.log_to_console = False
    pf.reset_counts()
    t0 = time.perf_counter()
    sol = solve_lp(dataclasses.replace(p50), s)  # a copy: its own cache
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    info = sol.get_additional_termination_information()
    _race_line(name, info, wall)
    obj = sol.get_primal_objective()
    rel = abs(obj - HIGHS_OBJ[50_000]) / abs(HIGHS_OBJ[50_000])
    launches = {k.name: k.launches for k in pf.KERNELS}
    total.update(launches)
    log(f"[concurrent] {name}: {sol.get_termination_reason()}, "
        f"{info['iterations']} steps, objective {obj:.6f} (rel err "
        f"{rel:.2e}), launches {launches} (float64 takes the unfused step)")
    require(sol.get_termination_reason() == "Optimal", f"{name}: status")
    require(rel <= OBJ_RTOL, f"{name}: objective {obj}")
    _no_simplex_thread_left(name)
    torch.cuda.empty_cache()
    return total


def phase_crossover(p2k, highs_2k):
    """PDLP in float32 on the block-band operator, then crossover to a
    vertex on the host: HiGHS's optimum within 1e-9, in fewer pivots than
    a cold simplex. Returns the kernels' launch counts.

    PDLP solves to CROSSOVER_TOL, not the default 1e-4: from most float32
    points at 1e-4 the shared C++ crossover crashes the process (its
    crash basis fails to factorize and simplex.cpp:99 -> :885 reads x_B
    before it exists; ROADMAP Queue 3)."""
    from cuopt_torch.dual_simplex.bindings import solve_lp_simplex
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
    return launches


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
    pf.reset_counts()
    t0 = time.perf_counter()
    warm = solve_lp(moved, _settings(20000, warm_start_data=ws))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in pf.KERNELS}
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
    require(launches["row_pass_atomic"] == attempts,
            f"warm re-solve: {launches['row_pass_atomic']} launches for "
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


# ------------------------------------------------------------------- main
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import cuopt_torch  # noqa: F401  (fails outside a checkout)
    from cuopt_torch.lp import pdhg_fused as pf

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
    for k in pf.KERNELS:
        require(total[k.name] > 0,
                f"{k.name} was never launched on the main path")

    phase_profile("staircase-50k", p50)
    phase_profile("staircase-300k", p300)
    phase_profile("degen-transport-100k", pd, DEGEN_STEPS)
    log(f"[profile] done at {time.perf_counter() - t_start:.1f} s")

    # each kernel at the shapes the main path gives it
    shape_of = {"row_pass_atomic": "staircase-50k",
                "row_pass_partials": "staircase-300k"}
    kernels = []
    for k in pf.KERNELS:
        rec = records[(shape_of[k.name], k.name)]
        kernels.append({
            "name": k.name, "route": "cuda",
            "source": f"cuopt_torch/csrc/{k.source}.cu",
            "replaces": k.replaces, "launches": total[k.name],
            "shape": shape_of[k.name],
            **rec,
            # the same kernel at the main path's widest window
            "degen_transport_100k": records[("degen-transport-100k",
                                             k.name)],
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
