"""cuopt_torch's solve_mip on the CPU, against cuopt_tpu's.

The small instances never start the FJ thread (20 variables or fewer and
an incumbent from the roundings), and both packages branch on the same
native simplex, so status and objective agree within 1e-9. On the mixed
staircase MIP the FJ thread runs beside the tree in both packages and
time decides what it contributes, so the objectives agree within the MIP
gap (relative 1e-4)."""

import dataclasses

import numpy as np
import pytest
import torch

from cuopt_torch import constants as C
from cuopt_torch.lp.internals import GetSolutionCallback, SetSolutionCallback
from cuopt_torch.lp.settings import MIPSolverSettings
from cuopt_torch.mip import feasibility_jump as TFJ
from cuopt_torch.mip.solve import HEURISTIC_THREAD, solve_mip
from cuopt_torch.problem.data_model import OptimizationProblem
from cuopt_torch.problem.synthetic import generate_lp
from torch_mip_instances import (
    brute_force_min,
    knapsack,
    staircase_mip,
    twelve_binaries,
)

torch.set_num_threads(1)


def trivial_presolve(P):
    """test_mip_solver.py:283: x0 fixed to 2 by its bounds."""
    A = np.array([[1.0, 0.0, 0.0], [1.0, 2.0, 3.0]])
    return P.from_dense(
        A, c=np.array([1.0, -3.0, -4.0]),
        constraint_lower=np.array([-np.inf, -np.inf]),
        constraint_upper=np.array([np.inf, 6.0]),
        variable_lower=np.array([2.0, 0.0, 0.0]),
        variable_upper=np.array([2.0, 1.0, 1.0]),
        variable_types=np.array(["I", "I", "I"]))


def probing_infeasible(P):
    """test_mip_solver.py:268: x + y >= 1.5 and x + y <= 0.5, binaries."""
    return P.from_dense(
        np.ones((2, 2)), c=np.array([1.0, 1.0]),
        constraint_lower=np.array([1.5, -np.inf]),
        constraint_upper=np.array([np.inf, 0.5]),
        variable_lower=np.zeros(2), variable_upper=np.ones(2),
        variable_types=np.array(["I", "I"]))


def _settings(S, time_limit=30.0, **kw):
    s = S()
    s.time_limit = time_limit
    s.log_to_console = False
    for k, v in kw.items():
        setattr(s, k, v)
    return s


def _staircase():
    return staircase_mip(generate_lp, 200, 0, with_point=True)


def _assert_feasible(p, x):
    assert np.all(x >= p.variable_lower_bounds - 1e-9)
    assert np.all(x <= p.variable_upper_bounds + 1e-9)
    is_int = p.variable_types == "I"
    assert np.array_equal(x[is_int], np.round(x[is_int]))
    act = p.to_dense() @ x
    assert np.all(act <= p.constraint_upper_bounds + 1e-6)
    assert np.all(act >= p.constraint_lower_bounds - 1e-6)


@pytest.mark.parametrize("name,instance", [
    ("knapsack", knapsack), ("twelve-binaries", twelve_binaries),
    ("trivial-presolve", trivial_presolve),
    ("probing-infeasible", probing_infeasible),
])
def test_small_mips_match_cuopt_tpu(name, instance):
    pytest.importorskip("jax")
    from cuopt_tpu.lp.settings import MIPSolverSettings as JSettings
    from cuopt_tpu.mip.solve import solve_mip as j_solve_mip
    from cuopt_tpu.problem.data_model import OptimizationProblem as JProb

    tp = instance(OptimizationProblem)
    t = solve_mip(tp, _settings(MIPSolverSettings), device="cpu")
    j = j_solve_mip(instance(JProb), _settings(JSettings))
    assert t.get_termination_status() == j.get_termination_status()
    assert t._raw["heuristic_errors"] == []
    if name == "probing-infeasible":
        assert t.get_termination_status() == \
            C.CUOPT_TERIMINATION_STATUS_INFEASIBLE
        return
    assert t.get_termination_status() == C.CUOPT_TERIMINATION_STATUS_OPTIMAL
    a, b = t.get_primal_objective(), j.get_primal_objective()
    assert abs(a - b) <= 1e-9 * max(1.0, abs(b))
    _assert_feasible(tp, t.get_primal_solution())
    assert abs(a - brute_force_min(tp)) <= 1e-9
    assert t.get_solution_bound() <= a + 1e-9


def test_staircase_mip_matches_cuopt_tpu():
    pytest.importorskip("jax")
    from cuopt_tpu.lp.settings import MIPSolverSettings as JSettings
    from cuopt_tpu.mip.solve import solve_mip as j_solve_mip
    from cuopt_tpu.problem.synthetic import generate_lp as j_generate

    # both trees prove optimality in about 10 s here; the long limit only
    # keeps a loaded machine from cutting them short
    tp, x_hat = _staircase()
    t = solve_mip(tp, _settings(MIPSolverSettings, 120.0), device="cpu")
    j = j_solve_mip(staircase_mip(j_generate, 200, 0),
                    _settings(JSettings, 120.0))
    ok = (C.CUOPT_TERIMINATION_STATUS_OPTIMAL,
          C.CUOPT_TERIMINATION_STATUS_FEASIBLE_FOUND)
    assert t.get_termination_status() in ok
    assert j.get_termination_status() in ok
    a, b = t.get_primal_objective(), j.get_primal_objective()
    assert abs(a - b) <= 1e-4 * max(1.0, abs(b)), (a, b)
    x = t.get_primal_solution()
    _assert_feasible(tp, x)
    assert a <= float(tp.objective_coefficients @ x_hat) + 1e-9
    assert t.get_solution_bound() <= a + 1e-9
    info = t.get_additional_termination_information()
    assert info["nodes"] >= 1 and info["heuristic_errors"] == []
    assert t._raw["fj"]["device"] == "cpu" and t._raw["fj"]["chunks"] >= 1
    assert HEURISTIC_THREAD not in [th.name for th in
                                    __import__("threading").enumerate()]
    # the user's problem is not modified by presolve
    assert np.array_equal(tp.variable_upper_bounds, np.ones(200))


def test_heuristics_only():
    """No tree: the roundings and the population loop only, for the
    time limit."""
    tp = twelve_binaries(OptimizationProblem)
    sol = solve_mip(tp, _settings(MIPSolverSettings, 2.0,
                                  heuristics_only=True), device="cpu")
    assert sol.get_termination_status() == \
        C.CUOPT_TERIMINATION_STATUS_FEASIBLE_FOUND
    _assert_feasible(tp, sol.get_primal_solution())
    assert sol.get_primal_objective() >= brute_force_min(tp) - 1e-9
    assert sol._raw["heuristic_errors"] == [] and sol._raw["nodes"] == 0


def test_callbacks_and_initial_solutions():
    """A GetSolutionCallback receives the population's new incumbents; a
    SetSolutionCallback, polled by the population loop, injects the
    optimum; an initial solution at the optimum is reported."""
    tp = twelve_binaries(OptimizationProblem)
    best = brute_force_min(tp)
    received = []

    class Get(GetSolutionCallback):
        def get_solution(self, solution, solution_cost):
            received.append((solution.copy(), float(solution_cost[0])))

    s = _settings(MIPSolverSettings)
    s.set_mip_callback(Get())
    sol = solve_mip(tp, s, device="cpu")
    assert received
    for x, cost in received:
        _assert_feasible(tp, x)
        assert cost == pytest.approx(float(tp.objective_coefficients @ x))
    assert sol.get_primal_objective() <= min(c for _, c in received)

    x_star = sol.get_primal_solution().copy()
    assert float(tp.objective_coefficients @ x_star) == best

    class Set(SetSolutionCallback):
        calls = 0

        def set_solution(self, solution, solution_cost):
            Set.calls += 1
            solution[:] = x_star
            solution_cost[0] = best

    s = _settings(MIPSolverSettings, 2.0, heuristics_only=True)
    s.set_mip_callback(Set())
    sol = solve_mip(tp, s, device="cpu")
    assert Set.calls >= 1 and sol.get_primal_objective() == best

    kp = knapsack(OptimizationProblem)
    s = _settings(MIPSolverSettings)
    s.set_initial_solution(np.array([1.0, 0.0, 3.0]))
    sol = solve_mip(kp, s, device="cpu")
    assert sol.get_primal_objective() == -14.0
    assert sol.get_termination_status() == \
        C.CUOPT_TERIMINATION_STATUS_OPTIMAL


def test_failing_fj_engine_is_recorded_and_bnb_answer_stands(monkeypatch):
    tp, x_hat = _staircase()

    def broken(self):
        raise RuntimeError("fj chunk failed")

    monkeypatch.setattr(TFJ.FjEngine, "step", broken)
    sol = solve_mip(dataclasses.replace(tp), _settings(MIPSolverSettings),
                    device="cpu")
    errors = sol._raw["heuristic_errors"]
    assert errors and all("fj chunk failed" in e for e in errors)
    assert any(e.startswith("feasibility jump thread") for e in errors)
    assert sol.get_termination_status() in (
        C.CUOPT_TERIMINATION_STATUS_OPTIMAL,
        C.CUOPT_TERIMINATION_STATUS_FEASIBLE_FOUND)
    _assert_feasible(tp, sol.get_primal_solution())
    assert sol.get_primal_objective() <= \
        float(tp.objective_coefficients @ x_hat) + 1e-9
    assert sol._raw["nodes"] >= 1
