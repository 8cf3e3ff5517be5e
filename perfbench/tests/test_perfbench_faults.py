"""A run with the timed path broken underneath comes out not correct.

Each case drives harness.run, past the look for a card, on the CPU at
4,096 rows, with the program's PDLP solver replaced by one that breaks
its answer where it is produced, and reads the result line."""

import dataclasses
import io
import json
import time

import numpy as np
import pytest
from cpu_card import small_runs

from perfbench import harness


def _broken(fault):
    from cuopt_torch import constants as C
    from cuopt_torch.lp.pdlp import PdlpSolver

    class Broken(PdlpSolver):
        calls = 0

        def run(self, timer=None, stop=None):
            n = self.prob.n_constraints
            if fault == "half_rows":
                # solve the first half of the rows only
                p, h = self.prob, n // 2
                self.prob = dataclasses.replace(
                    p, offsets=p.offsets[:h + 1],
                    indices=p.indices[:p.offsets[h]],
                    values=p.values[:p.offsets[h]],
                    constraint_lower_bounds=p.constraint_lower_bounds[:h],
                    constraint_upper_bounds=p.constraint_upper_bounds[:h])
            raw = super().run(timer, stop)
            x, y = raw["primal_solution"], raw["dual_solution"]
            if fault == "unchanged":  # the initial state, returned as is
                raw["primal_solution"] = np.zeros_like(x)
                raw["dual_solution"] = np.zeros_like(y)
                raw["primal_objective"] = 0.0
            elif fault == "half_rows":
                raw["dual_solution"] = np.concatenate(
                    [y, np.zeros(n - len(y))])
            elif fault == "x_reversed":  # an order not undone
                raw["primal_solution"] = x[::-1].copy()
            elif fault == "objective":
                raw["primal_objective"] *= 1.01
            elif fault == "infeasible":
                raw["status"] = C.CUOPT_TERIMINATION_STATUS_INFEASIBLE
            elif fault == "stopped_early" and Broken.calls % 2:
                # every other solve stops at an iteration limit, its
                # answer as far as it got
                raw["status"] = C.CUOPT_TERIMINATION_STATUS_ITERATION_LIMIT
            Broken.calls += 1
            return raw

    return Broken


def _run(workload, monkeypatch, fault=None, seconds=1.0):
    if fault is not None:
        import cuopt_torch.lp.solve as S

        monkeypatch.setattr(S, "PdlpSolver", _broken(fault))

    small_runs(harness, monkeypatch.setattr)
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(workload, 2**31 + 99, seconds, False, time.perf_counter(),
                     out=out, err=err)
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert err.getvalue().splitlines()[-len(line["checks"]):] == [
        f"check {k}: {v['value']} limit {v['limit']}"
        for k, v in line["checks"].items()]
    return line


@pytest.mark.parametrize("workload", ["stair50k.ordered",
                                      "stair50k.shuffled"])
def test_sound_run_is_correct(workload, monkeypatch):
    line = _run(workload, monkeypatch)
    assert line["correct"] and line["failed"] == 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("fault", ["unchanged", "half_rows", "x_reversed",
                                   "objective", "infeasible"])
def test_broken_run_is_not_correct(fault, monkeypatch):
    line = _run("stair50k.shuffled", monkeypatch, fault)
    assert not line["correct"]
    assert line["failed"] == line["attempted"] >= 1


def test_solves_stopped_early_are_not_correct(monkeypatch):
    """Half the solves end at an iteration limit, the rest optimal: the
    optimal answers pass the KKT check, and the run is still not
    correct."""
    line = _run("stair50k.ordered", monkeypatch, "stopped_early", 3.0)
    assert not line["correct"]
    checks = line["checks"]
    assert checks["kkt_worst"]["value"] <= checks["kkt_worst"]["limit"]
    assert checks["wrong_claims"]["value"] == 0
    assert checks["not_optimal"]["value"] == line["failed"] >= 1
    assert line["failed"] < line["attempted"]
