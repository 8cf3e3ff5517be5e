"""cuopt_torch's branch-and-bound: the four tests of
tests/test_branch_and_bound.py on the port, and parity with cuopt_tpu's
tree on simplex nodes (both packages solve each node with the same native
dual simplex, so the trees are the same)."""

import math

import numpy as np
import pytest
import torch

from cuopt_torch import constants as C
from cuopt_torch.lp.settings import MIPSolverSettings
from cuopt_torch.mip.branch_and_bound import BranchAndBound
from cuopt_torch.problem.data_model import OptimizationProblem
from cuopt_torch.utils.timer import Timer
from torch_mip_instances import brute_force_min, knapsack, twelve_binaries

torch.set_num_threads(1)


class LimitFirstBnB(BranchAndBound):
    """Forces the FIRST node relaxation to report an iteration limit."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.calls = 0

    def _solve_relaxation(self, lv, uv, x_warm=None, y_warm=None,
                          timer=None, effort=1, **kw):
        raw = super()._solve_relaxation(lv, uv, x_warm, y_warm, timer,
                                        effort, **kw)
        self.calls += 1
        if self.calls == 1:
            raw = dict(raw)
            raw["status"] = C.CUOPT_TERIMINATION_STATUS_ITERATION_LIMIT
        return raw


class AlwaysLimitBnB(BranchAndBound):
    """Every node relaxation reports an iteration limit (never resolves)."""

    def _solve_relaxation(self, lv, uv, x_warm=None, y_warm=None,
                          timer=None, effort=1, **kw):
        raw = super()._solve_relaxation(lv, uv, x_warm, y_warm, timer,
                                        effort, **kw)
        raw = dict(raw)
        raw["status"] = C.CUOPT_TERIMINATION_STATUS_ITERATION_LIMIT
        return raw


def test_limit_hit_node_is_requeued_not_dropped():
    bnb = LimitFirstBnB(knapsack(OptimizationProblem), MIPSolverSettings(),
                        device="cpu")
    res = bnb.solve(Timer(120.0))
    assert res["status"] == C.CUOPT_TERIMINATION_STATUS_OPTIMAL
    x = res["incumbent"]
    assert np.allclose(x, np.round(x), atol=1e-6)
    assert res["incumbent_obj"] <= -12.9
    assert res["best_bound"] <= res["incumbent_obj"] + 1e-6
    assert bnb.calls >= 2  # the limited node really was re-solved


def test_never_resolving_node_blocks_optimal_claim():
    bnb = AlwaysLimitBnB(knapsack(OptimizationProblem), MIPSolverSettings(),
                         device="cpu")
    bnb.set_incumbent(np.array([1.0, 1.0, 0.0]), -9.0)
    res = bnb.solve(Timer(30.0))
    assert res["status"] == C.CUOPT_TERIMINATION_STATUS_FEASIBLE_FOUND
    assert res["incumbent_obj"] == -9.0


def test_safe_dual_bound_is_rigorous():
    p = knapsack(OptimizationProblem)
    bnb = BranchAndBound(p, MIPSolverSettings(), device="cpu")
    lv, uv = p.variable_lower_bounds, p.variable_upper_bounds
    raw = bnb._solve_relaxation(lv, uv, timer=Timer(60.0))
    lp_opt = raw["primal_objective"]
    rng = np.random.default_rng(0)
    for _ in range(20):
        y = rng.normal(size=p.n_constraints) * 10.0
        assert bnb._safe_dual_bound(y, lv, uv) <= lp_opt + 1e-6
    b_star = bnb._safe_dual_bound(raw["dual_solution"], lv, uv)
    assert lp_opt - 1e-2 * max(1.0, abs(lp_opt)) <= b_star <= lp_opt + 1e-6
    assert not math.isnan(b_star)


def test_batched_frontier_relaxations():
    """Node relaxations by PDLP (use_simplex=False): the frontier's nodes
    are stacked into one batched program (lp/batch.py) and the tree
    reaches the brute-force optimum."""
    p = twelve_binaries(OptimizationProblem)
    bnb = BranchAndBound(p, MIPSolverSettings(), device="cpu")
    bnb.use_simplex = False
    calls = {"batched": 0, "single": 0}
    orig_batch = bnb._solve_relaxations_batch
    orig_single = bnb._solve_relaxation

    def spy_batch(nodes, timer):
        calls["batched"] += len(nodes)
        raws = orig_batch(nodes, timer)
        assert all(r["solved_by"] == "pdlp_batch" for r in raws)
        return raws

    def spy_single(*a, **k):
        calls["single"] += 1
        return orig_single(*a, **k)

    bnb._solve_relaxations_batch = spy_batch
    bnb._solve_relaxation = spy_single
    res = bnb.solve(Timer(300.0))
    assert res["status"] == C.CUOPT_TERIMINATION_STATUS_OPTIMAL
    x = res["incumbent"]
    assert np.allclose(x, np.round(x), atol=1e-6)
    assert res["best_bound"] <= res["incumbent_obj"] + 1e-6
    assert calls["batched"] >= 4, calls
    assert abs(res["incumbent_obj"] - brute_force_min(p)) < 1e-6


@pytest.mark.parametrize("instance", [knapsack, twelve_binaries])
def test_simplex_tree_matches_cuopt_tpu(instance):
    pytest.importorskip("jax")
    from cuopt_tpu.linear_programming import MIPSolverSettings as JSettings
    from cuopt_tpu.mip.branch_and_bound import BranchAndBound as JBnB
    from cuopt_tpu.problem.data_model import OptimizationProblem as JProb
    from cuopt_tpu.utils.timer import Timer as JTimer

    t = BranchAndBound(instance(OptimizationProblem), MIPSolverSettings(),
                       device="cpu")
    j = JBnB(instance(JProb), JSettings())
    assert t.use_simplex and j.use_simplex
    tr, jr = t.solve(Timer(60.0)), j.solve(JTimer(60.0))
    assert tr["status"] == jr["status"] == \
        C.CUOPT_TERIMINATION_STATUS_OPTIMAL
    assert np.array_equal(tr["incumbent"], jr["incumbent"])
    assert tr["incumbent_obj"] == jr["incumbent_obj"]
    assert tr["best_bound"] == jr["best_bound"]
    assert tr["nodes"] == jr["nodes"]
    assert tr["simplex_iters"] == jr["simplex_iters"]
