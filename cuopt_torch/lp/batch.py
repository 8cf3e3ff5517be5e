"""Batch LP solve.

Counterpart of cuopt_tpu/lp/batch.py (reference cython_solve.cu
`call_batch_solve` :264-290: one CUDA stream and raft handle per LP).
Same-shape problems are STACKED along a leading batch axis and solved by
one batched program: torch.func.vmap over a PDLP step attempt and over
the end of a major (lp/pdlp.py `_attempt`, `major_tail`). Each member
carries its own step size, primal weight, restart bookkeeping and
termination flags; the host loop snapshots a member's solution at the
first major it terminates and runs the batch until every member is done
(or a limit is hit).

The attempt loop is masked: each pass computes one attempt for every
member, accepts it where the attempt is valid (or the member reached
`max_step_attempts`), and moves the others to their next step size;
members that have accepted keep their values. That is one host sync per
pass for the whole batch, as the solo loop has one per attempt, and each
member follows the trajectory it would follow alone.

The batch runs no CUDA graph and no step kernel: every pass is eager.
Its spans (utils/tracing.py) are `pdlp_batch_build` (the members'
builds, initial states and the stack), `pdlp_batch_steps` (a major's
passes), `pdlp_batch_sync` (a pass's read), `pdlp_batch_tail` (the
vmapped major tail) and `pdlp_batch_readback` (a major's packed read
and the answers of the members it ends). Every member's raw result
carries the batch's counters, the same for all its members:
`batch_size`, `batch_passes` (attempt passes), `batch_syncs` (the
passes' reads and the majors' packed reads), `batch_steps` (the stacked
loop's steps) and the walls `batch_build_s` and `batch_loop_s`.

The stacked operator is dense `(B, n, m)` (batched matmuls), block-band
slabs `(B, T, 128, W)` with shared window starts when every member has
one sparsity pattern (the B&B node-relaxation case), or ELL padded to a
common width. The fused row pass is a per-problem kernel and stays off.
Groups of fewer than two members, and groups too large for a stacked
operator, are solved one by one with `solve_lp`; nothing else falls back.

With a `mesh` (parallel/sharding.py) each group is split over the mesh's
shards, as cuopt_tpu shards the batch axis (batch.py:123-147): padded to
a multiple of the shard count by repeating its last member (the
duplicates are solved and their results dropped), each shard runs the
stacked program of its own members on its own device and stream, and
the answers come back in the members' order. The shards need no
collective: every member follows its own trajectory, and every member
of a batch takes the same number of steps per major, so each shard's
loop ends where the whole batch's would have ended for its members.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.func import vmap

from cuopt_torch import constants as C
from cuopt_torch.lp.pdlp import (
    PdlpSolver,
    _accept,
    _attempt,
    _np,
    build_device_problem,
    initial_state,
    major_tail,
)
from cuopt_torch.lp.settings import PDLPSolverSettings
from cuopt_torch.lp.solution import Solution
from cuopt_torch.lp.solve import solve_lp
from cuopt_torch.parallel.sharding import run_spmd
from cuopt_torch.sparse.ops import EllOp
from cuopt_torch.utils.timer import Timer
from cuopt_torch.utils.tracing import trace_scope

# size threshold below which the stacked operator is simply DENSE;
# larger same-shape members batch via stacked BlockBand (identical
# sparsity pattern) or common-width ELL (arbitrary patterns). The same
# limits as cuopt_tpu/lp/batch.py:34-36.
_BATCH_DENSE_LIMIT = 1 << 21
# stacked-ELL memory guard (elements across the whole batch)
_BATCH_ELL_LIMIT = 1 << 27

# per-major scalars read back in ONE transfer per batch
_SCALAR_KEYS = ("opt_cur", "opt_avg", "numerical_error", "total_steps",
                "primal_infeasible", "dual_infeasible")


def _groupable(prob, settings):
    return (
        prob.n_constraints > 0
        and prob.n_variables > 0
        and settings.warm_start_data is None
        and settings.initial_primal_solution is None
        and settings.initial_dual_solution is None
        and not settings.crossover
    )


def batch_solve(probs, settings=None, device="cuda",
                mesh=None) -> list[Solution]:
    """Solve a list of LPs; same-shape members are stacked into one
    batched program on `device` (reference BatchSolve,
    solver/solver.py:101), or split over the shards of `mesh`. "cuda"
    unless the caller asks for "cpu": without a card the call raises."""
    settings = settings or PDLPSolverSettings()
    device = torch.device(device)
    torch.empty(0, device=device)  # no card: raises here, not later
    results: list[Solution | None] = [None] * len(probs)

    groups: dict[tuple[int, int], list[int]] = {}
    for i, p in enumerate(probs):
        if _groupable(p, settings):
            groups.setdefault(
                (p.n_constraints, p.n_variables), []).append(i)
    for idxs in groups.values():
        if len(idxs) < 2:
            continue
        members = [probs[i] for i in idxs]
        kind = _pick_batch_kind(members)
        if kind is None:
            continue
        if mesh is None:
            sols = _solve_stacked(members, settings, kind, device)
        else:
            sols = _solve_sharded(members, settings, kind, mesh)
        for i, sol in zip(idxs, sols):
            results[i] = sol
    for i, p in enumerate(probs):
        if results[i] is None:
            results[i] = solve_lp(p, settings, device)
    return results


# --------------------------------------------------- stacking dataclasses
def _tensors(obj) -> dict:
    """{field path: tensor} of a dataclass (the operator's fields under
    "op.<name>"); None and Python fields stay with the template."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v
        elif dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": t for k, t in _tensors(v).items()})
    return out


def _join(template, leaves: dict):
    """`template` with its tensor fields replaced by `leaves` (the inverse
    of `_tensors`)."""
    kw, nested = {}, {}
    for k, v in leaves.items():
        head, _, rest = k.partition(".")
        if rest:
            nested.setdefault(head, {})[rest] = v
        else:
            kw[head] = v
    for head, sub in nested.items():
        kw[head] = _join(getattr(template, head), sub)
    return dataclasses.replace(template, **kw)


def _stack(objs) -> dict:
    leaves = [_tensors(o) for o in objs]
    return {k: torch.stack([lv[k] for lv in leaves]) for k in leaves[0]}


def _where(mask, a, b):
    """torch.where over a leading batch axis."""
    return torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b)


def _batched_fns(cfg, dev_tpl, st_tpl):
    """The vmapped attempt, accept and major tail over stacked leaves."""
    def attempt(dev_l, st_l, grad, eta, attempts):
        return _attempt(_join(dev_tpl, dev_l), _join(st_tpl, st_l), cfg,
                        grad, eta, attempts)

    def accept(st_l, cand, eta, eta_next, attempts):
        return _tensors(_accept(_join(st_tpl, st_l), cand, eta, eta_next,
                                attempts))

    def tail(dev_l, st_l):
        s, report = major_tail(_join(dev_tpl, dev_l), _join(st_tpl, st_l),
                               cfg)
        return _tensors(s), report

    return vmap(attempt), vmap(accept), vmap(tail)


def _batched_step(fns, dev_b, st_b, max_attempts):
    """One PDHG step of every member: the masked attempt loop. Returns
    (stacked state, attempt passes)."""
    attempt, accept, _ = fns
    grad = dev_b["c"] - st_b["aty"]
    eta = st_b["step_size"]
    attempts = torch.zeros_like(st_b["total_steps"])
    done = torch.zeros_like(attempts, dtype=torch.bool)
    acc = None
    passes = 0
    while True:
        cand, valid, eta_next = attempt(dev_b, st_b, grad, eta, attempts)
        passes += 1
        attempts = attempts + (~done).to(attempts.dtype)
        take = ~done & (valid | (attempts >= max_attempts))
        if acc is None:
            acc, acc_eta, acc_next = cand, eta, eta_next
        else:
            acc = {k: _where(take, cand[k], acc[k]) for k in cand}
            acc_eta = torch.where(take, eta, acc_eta)
            acc_next = torch.where(take, eta_next, acc_next)
        done = done | take
        # one device sync per pass, for the whole batch
        with trace_scope("pdlp_batch_sync"):
            all_done = bool(done.all())
        if all_done:
            break
        eta = torch.where(done, eta, eta_next)
    return accept(st_b, acc, acc_eta, acc_next, attempts), passes


def _batched_major(fns, dev_b, st_b, cfg):
    """One major iteration of every member: (stacked state, report); the
    report's "passes" is the major's attempt passes, a host int."""
    passes = 0
    with trace_scope("pdlp_batch_steps"):
        for _ in range(cfg.hp.major_iteration):
            st_b, n = _batched_step(fns, dev_b, st_b, cfg.max_step_attempts)
            passes += n
    with trace_scope("pdlp_batch_tail"):
        st_b, report = fns[2](dev_b, st_b)
    report["passes"] = passes
    return st_b, report


def _solve_stacked(probs, settings, kind, device):
    B = len(probs)
    solver0 = PdlpSolver(probs[0], settings, device)
    hp, dtype = solver0.hp, solver0.dtype
    # the fused row pass is a per-problem kernel: off for a batch
    cfg = dataclasses.replace(solver0.cfg, fused_kernel="off")
    timer = Timer(settings.time_limit)

    t_build = time.perf_counter()
    with trace_scope("pdlp_batch_build"):
        devs = [build_device_problem(p, hp, dtype, kind, device)
                for p in probs]
        states = [initial_state(d, hp, dtype) for d in devs]
        if kind == "ell":
            devs = _normalize_ell_widths(devs)
        dev_b, st_b = _stack(devs), _stack(states)
    build_s = time.perf_counter() - t_build
    fns = _batched_fns(cfg, devs[0], states[0])

    needed_streak = 1 if settings.strict_infeasibility else 2
    done = np.zeros(B, bool)
    snapshots: list[dict | None] = [None] * B
    inf_streak = np.zeros(B, int)
    unb_streak = np.zeros(B, int)
    passes = majors = 0
    t_loop = time.perf_counter()
    while True:
        st_b, report = _batched_major(fns, dev_b, st_b, cfg)
        passes += report["passes"]
        majors += 1
        with trace_scope("pdlp_batch_readback"):
            packed = _np(torch.stack([report[k].to(torch.float64)
                                      for k in _SCALAR_KEYS]))
            opt_cur, opt_avg, numerical = (packed[i] > 0 for i in range(3))
            steps = packed[3].astype(np.int64)
            it = int(steps.max())
            if settings.detect_infeasibility:
                inf_streak = np.where(packed[4] > 0, inf_streak + 1, 0)
                unb_streak = np.where(packed[5] > 0, unb_streak + 1, 0)
            newly = ~done & (opt_cur | opt_avg | numerical
                             | (inf_streak >= needed_streak)
                             | (unb_streak >= needed_streak))
            hit_limits = it >= settings.iteration_limit or timer.expired()
            for b in np.flatnonzero(newly | (~done if hit_limits
                                             else False)):
                if numerical[b]:
                    st = C.CUOPT_TERIMINATION_STATUS_NUMERICAL_ERROR
                elif opt_cur[b] or opt_avg[b]:
                    st = C.CUOPT_TERIMINATION_STATUS_OPTIMAL
                elif inf_streak[b] >= needed_streak:
                    st = C.CUOPT_TERIMINATION_STATUS_INFEASIBLE
                elif unb_streak[b] >= needed_streak:
                    st = C.CUOPT_TERIMINATION_STATUS_UNBOUNDED
                elif it >= settings.iteration_limit:
                    st = C.CUOPT_TERIMINATION_STATUS_ITERATION_LIMIT
                else:
                    st = C.CUOPT_TERIMINATION_STATUS_TIME_LIMIT
                use_avg = bool(opt_avg[b]) and not bool(opt_cur[b])
                snapshots[b] = _extract_one(report, b, use_avg, st, timer)
                done[b] = True
        if done.all():
            break
    # the same for every member: the batch's own counters and walls
    counters = {
        "batch_size": B, "batch_passes": passes,
        # one read a pass, one packed read a major
        "batch_syncs": passes + majors, "batch_steps": it,
        "batch_build_s": build_s,
        "batch_loop_s": time.perf_counter() - t_loop,
    }
    out = []
    for p, raw in zip(probs, snapshots):
        raw.update(counters)
        if p.maximize:  # undo the internal minimize transform
            raw["primal_objective"] = -raw["primal_objective"]
            raw["dual_objective"] = -raw["dual_objective"]
            raw["dual_solution"] = -raw["dual_solution"]
            raw["reduced_cost"] = -raw["reduced_cost"]
        out.append(Solution(p, raw))
    return out


def _solve_sharded(probs, settings, kind, mesh):
    """The batch split over the shards of `mesh` (see the module
    docstring)."""
    D, B = mesh.size, len(probs)
    padded = list(probs) + [probs[-1]] * ((-B) % D)
    per = len(padded) // D
    chunks = [(padded[d * per:(d + 1) * per],) for d in range(D)]
    out = run_spmd(mesh, lambda comm, members: _solve_stacked(
        members, settings, kind, comm.device), chunks)
    return [sol for sols in out for sol in sols][:B]


def _extract_one(report, b, use_avg, status, timer):
    which = "avg" if use_avg else "cur"
    info = {k: float(v[b]) for k, v in report[f"info_{which}"].items()}
    return {
        "status": status,
        "iterations": int(report["total_steps"][b]),
        "attempts": int(report["total_attempts"][b]),
        "solve_time": timer.elapsed(),
        "primal_solution": _np(report[f"x_{which}"][b]),
        "dual_solution": _np(report[f"y_{which}"][b]),
        "reduced_cost": _np(report[f"reduced_cost_{which}"][b]),
        "primal_objective": info["primal_obj"],
        "dual_objective": info["dual_obj"],
        "gap": info["gap"],
        "l2_primal_residual": info["l2_primal_res"],
        "l2_dual_residual": info["l2_dual_res"],
        "linf_primal_residual": info["linf_primal_res"],
        "linf_dual_residual": info["linf_dual_res"],
        "solved_by": "pdlp_batch",
    }


def _pick_batch_kind(probs):
    """Stacked operator for a same-shape batch: "dense" when small;
    "blockband" when every member shares ONE sparsity pattern (identical
    window metadata stacks trivially); else common-width "ell"; None when
    the stacked ELL would pass `_BATCH_ELL_LIMIT` (cuopt_tpu raises
    there and its caller solves the group one by one, as batch_solve
    does on None)."""
    p0 = probs[0]
    if p0.n_constraints * p0.n_variables <= _BATCH_DENSE_LIMIT:
        return "dense"
    same_pattern = all(
        p.nnz == p0.nnz
        and np.array_equal(p.offsets, p0.offsets)
        and np.array_equal(p.indices, p0.indices)
        for p in probs[1:]
    )
    if same_pattern:
        return "blockband"
    total_ell = 0
    for p in probs:
        wr = int(np.max(np.diff(p.offsets), initial=1))
        total_ell += p.n_constraints * wr * 2
    if total_ell <= _BATCH_ELL_LIMIT:
        return "ell"
    return None


def _normalize_ell_widths(devs):
    """Pad every member's ELL arrays to the batch-wide widths so that they
    stack (padded entries are value 0 / index 0, the EllOp convention)."""
    ops = [d.op for d in devs]
    if not all(isinstance(o, EllOp) for o in ops):
        return devs
    wr = max(o.row_vals.shape[1] for o in ops)
    wc = max(o.col_vals.shape[1] for o in ops)

    def pad(a, w):
        return torch.nn.functional.pad(a, (0, w - a.shape[1]))

    return [dataclasses.replace(d, op=o.replace(
        row_vals=pad(o.row_vals, wr), row_cols=pad(o.row_cols, wr),
        col_vals=pad(o.col_vals, wc), col_rows=pad(o.col_rows, wc),
    )) for d, o in zip(devs, ops)]
