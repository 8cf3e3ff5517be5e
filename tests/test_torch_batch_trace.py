"""The batch LP's spans and counters (lp/batch.py), on CPU tensors.

A stacked block-band batch of members that share one matrix and differ
in a few variable bounds, as a MIP frontier sends them
(`perfbench/drivers/lp_batch.py` makes them the same way at 50k). The
counters each member's raw result carries must agree with what the loop
did: at least as many attempt passes as the member with the most
attempts took, one read a pass and one a major, the stacked loop's steps
equal to the largest member's; the five spans open under torch.profiler
as often as the counters say. The counters change nothing computed: the
answers are bit for bit those of the loop as it ran before it counted,
kept below as the oracle `_uncounted_solve`.
"""

import dataclasses

import numpy as np
import pytest
import torch

import cuopt_torch.lp.batch as TB
from cuopt_torch import constants as C
from cuopt_torch.lp import pdlp as TP
from cuopt_torch.lp.settings import PDLPSolverSettings
from cuopt_torch.problem.data_model import OptimizationProblem
from perfbench import lpgen

torch.set_num_threads(1)

SPANS = ("pdlp_batch_build", "pdlp_batch_steps", "pdlp_batch_sync",
         "pdlp_batch_tail", "pdlp_batch_readback")
COUNTERS = ("batch_size", "batch_passes", "batch_syncs", "batch_steps",
            "batch_build_s", "batch_loop_s")


def _members(n=400, B=3, seed=5):
    """B copies of one staircase, each with lv = 0.1 or uv = 0.9 on a
    seeded 2% of its columns (the generator's interior point lies in
    [0.2, 0.8], so every member stays feasible)."""
    lp = lpgen.staircase(n, n, 8, 64, seed)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        lv, uv = lp["lv"].copy(), lp["uv"].copy()
        cols = rng.choice(n, n // 50, replace=False)
        low = rng.random(len(cols)) < 0.5
        lv[cols[low]] = 0.1
        uv[cols[~low]] = 0.9
        out.append(OptimizationProblem(
            offsets=lp["offsets"], indices=lp["indices"],
            values=lp["values"], objective_coefficients=lp["c"],
            constraint_lower_bounds=lp["lc"],
            constraint_upper_bounds=lp["uc"],
            variable_lower_bounds=lv, variable_upper_bounds=uv))
    return out


def _settings():
    s = PDLPSolverSettings()
    s.method = C.CUOPT_METHOD_PDLP
    s.log_to_console = False
    return s


@pytest.fixture(scope="module")
def solved():
    """(members, solutions, the profiler's span counts), the small
    members stacked as a block band, as at the cell's size."""
    probs = _members()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TB, "_BATCH_DENSE_LIMIT", 0)
        assert TB._pick_batch_kind(probs) == "blockband"
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            sols = TB.batch_solve(probs, _settings(), device="cpu")
    spans = {}
    for e in prof.events():
        if e.name in SPANS:
            spans[e.name] = spans.get(e.name, 0) + 1
    return probs, sols, spans


def test_every_member_carries_the_same_counters(solved):
    probs, sols, _ = solved
    raws = [s._raw for s in sols]
    assert all(r["solved_by"] == "pdlp_batch" for r in raws)
    assert all(s.get_termination_reason() == "Optimal" for s in sols)
    first = {k: raws[0][k] for k in COUNTERS}
    assert all({k: r[k] for k in COUNTERS} == first for r in raws)
    assert first["batch_size"] == len(probs)
    assert first["batch_build_s"] > 0 and first["batch_loop_s"] > 0


def test_counters_agree_with_the_loop(solved):
    _, sols, _ = solved
    raws = [s._raw for s in sols]
    r = raws[0]
    major = TP.PRESETS[_settings().pdlp_solver_mode].major_iteration
    majors = r["batch_steps"] // major
    # every member's attempts take a pass each; a member that accepts
    # early waits for the others, so the passes are at least the most
    assert r["batch_passes"] >= max(x["attempts"] for x in raws)
    assert r["batch_passes"] >= r["batch_steps"]
    # one read a pass, one packed read a major
    assert r["batch_syncs"] == r["batch_passes"] + majors
    # the stacked loop runs until its last member ends
    assert r["batch_steps"] == max(x["iterations"] for x in raws)
    assert r["batch_steps"] % major == 0


def test_spans_open_as_often_as_the_counters_say(solved):
    _, sols, spans = solved
    r = sols[0]._raw
    major = TP.PRESETS[_settings().pdlp_solver_mode].major_iteration
    majors = r["batch_steps"] // major
    assert spans == {
        "pdlp_batch_build": 1, "pdlp_batch_steps": majors,
        "pdlp_batch_sync": r["batch_passes"], "pdlp_batch_tail": majors,
        "pdlp_batch_readback": majors}
    assert spans["pdlp_batch_sync"] + spans["pdlp_batch_readback"] == \
        r["batch_syncs"]


# ------------------------------------------------ the loop before counting
def _uncounted_step(fns, dev_b, st_b, max_attempts):
    """The masked attempt loop as it ran before it counted its passes."""
    attempt, accept, _ = fns
    grad = dev_b["c"] - st_b["aty"]
    eta = st_b["step_size"]
    attempts = torch.zeros_like(st_b["total_steps"])
    done = torch.zeros_like(attempts, dtype=torch.bool)
    acc = None
    while True:
        cand, valid, eta_next = attempt(dev_b, st_b, grad, eta, attempts)
        attempts = attempts + (~done).to(attempts.dtype)
        take = ~done & (valid | (attempts >= max_attempts))
        if acc is None:
            acc, acc_eta, acc_next = cand, eta, eta_next
        else:
            acc = {k: TB._where(take, cand[k], acc[k]) for k in cand}
            acc_eta = torch.where(take, eta, acc_eta)
            acc_next = torch.where(take, eta_next, acc_next)
        done = done | take
        if bool(done.all()):
            break
        eta = torch.where(done, eta, eta_next)
    return accept(st_b, acc, acc_eta, acc_next, attempts)


def _uncounted_solve(probs, settings):
    """Each member's (x, y, steps, attempts) at the major it ends, by
    optimality, as the batch loop found them before it counted."""
    solver0 = TP.PdlpSolver(probs[0], settings, "cpu")
    cfg = dataclasses.replace(solver0.cfg, fused_kernel="off")
    devs = [TP.build_device_problem(dataclasses.replace(p), solver0.hp,
                                    solver0.dtype, "blockband", "cpu")
            for p in probs]
    states = [TP.initial_state(d, solver0.hp, solver0.dtype) for d in devs]
    dev_b, st_b = TB._stack(devs), TB._stack(states)
    fns = TB._batched_fns(cfg, devs[0], states[0])
    out = [None] * len(probs)
    while any(o is None for o in out):
        for _ in range(cfg.hp.major_iteration):
            st_b = _uncounted_step(fns, dev_b, st_b, cfg.max_step_attempts)
        st_b, rep = fns[2](dev_b, st_b)
        for b in range(len(probs)):
            cur, avg = bool(rep["opt_cur"][b]), bool(rep["opt_avg"][b])
            if out[b] is None and (cur or avg):
                which = "avg" if avg and not cur else "cur"
                out[b] = (rep[f"x_{which}"][b].numpy().copy(),
                          rep[f"y_{which}"][b].numpy().copy(),
                          int(rep["total_steps"][b]),
                          int(rep["total_attempts"][b]))
    return out


def test_answers_bit_for_bit_those_of_the_uncounted_loop(solved):
    probs, sols, _ = solved
    oracle = _uncounted_solve(probs, _settings())
    for sol, (x, y, steps, attempts) in zip(sols, oracle):
        assert sol.get_nb_iterations() == steps
        assert sol._raw["attempts"] == attempts
        assert np.array_equal(sol.get_primal_solution(), x)
        assert np.array_equal(sol.get_dual_solution(), y)
