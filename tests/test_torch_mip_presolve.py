"""cuopt_torch's MIP presolve against cuopt_tpu's, plus the presolve
cases of tests/test_mip_solver.py run on the port.

The port keeps its own copy of the numpy presolve, so on the same seeded
MIPs both give equal arrays.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cuopt_torch import constants as TC
from cuopt_torch.lp.settings import MIPSolverSettings
from cuopt_torch.mip import presolve as T
from cuopt_torch.mip.solve import solve_mip
from cuopt_torch.problem.data_model import OptimizationProblem as TProb

J = pytest.importorskip("cuopt_tpu.mip.presolve")
from cuopt_tpu.problem.data_model import OptimizationProblem as JProb  # noqa: E402
from torch_mip_instances import brute_force_min, twelve_binaries  # noqa: E402

torch.set_num_threads(1)


def random_mip(seed, n=40, m=30, P=TProb):
    """A seeded sparse MIP with integer, binary and continuous columns,
    some infinite bounds, and ranged, one-sided and equality rows."""
    rng = np.random.default_rng(seed)
    A = np.where(rng.random((n, m)) < 0.15,
                 rng.integers(-4, 6, (n, m)), 0).astype(float)
    x0 = rng.integers(0, 3, m).astype(float)
    act = A @ x0
    kind = rng.integers(0, 3, n)
    lo = np.where(kind == 1, -np.inf, act - rng.integers(0, 3, n))
    hi = np.where(kind == 2, np.inf, act + rng.integers(0, 3, n))
    hi = np.where(kind == 0, np.maximum(hi, lo), hi)
    vt = rng.choice(["I", "C"], m, p=[0.7, 0.3])
    lv = np.where(rng.random(m) < 0.1, -np.inf, 0.0)
    uv = np.where(rng.random(m) < 0.2, np.inf,
                  np.where(rng.random(m) < 0.5, 1.0, 4.0))
    return P.from_dense(A, rng.normal(size=m), lo, hi,
                        variable_lower=lv, variable_upper=uv,
                        variable_types=vt)


def _args(p):
    return (p.offsets, p.indices, p.values, p.constraint_lower_bounds,
            p.constraint_upper_bounds, p.variable_lower_bounds,
            p.variable_upper_bounds, p.variable_types == "I")


@pytest.mark.parametrize("seed", range(6))
def test_propagate_and_probe_equal(seed):
    tp, jp = random_mip(seed), random_mip(seed, P=JProb)
    for rounds in (1, 10):
        a = T.propagate_bounds(*_args(tp), max_rounds=rounds)
        b = J.propagate_bounds(*_args(jp), max_rounds=rounds)
        assert np.array_equal(a.lv, b.lv) and np.array_equal(a.uv, b.uv)
        assert (a.infeasible, a.n_rounds, a.tightened) == \
            (b.infeasible, b.n_rounds, b.tightened)
    a = T.probe_variables(*_args(tp))
    b = J.probe_variables(*_args(jp))
    assert np.array_equal(a.lv, b.lv) and np.array_equal(a.uv, b.uv)
    assert (a.infeasible, a.n_probed, a.n_fixed, a.tightened) == \
        (b.infeasible, b.n_probed, b.n_fixed, b.tightened)
    assert a.cache.keys() == b.cache.keys()
    for j in a.cache:
        assert a.cache[j].keys() == b.cache[j].keys()
        for v in a.cache[j]:
            for x, y in zip(a.cache[j][v], b.cache[j][v]):
                assert np.array_equal(x, y)


@pytest.mark.parametrize("seed", range(4))
def test_eliminate_fixed_equal(seed):
    tp, jp = random_mip(seed), random_mip(seed, P=JProb)
    rng = np.random.default_rng(100 + seed)
    fix = rng.random(tp.n_variables) < 0.3
    val = rng.integers(0, 2, tp.n_variables).astype(float)
    lv = np.where(fix, val, tp.variable_lower_bounds)
    uv = np.where(fix, val, tp.variable_upper_bounds)
    a, b = T.eliminate_fixed(tp, lv, uv), J.eliminate_fixed(jp, lv, uv)
    for f in ("keep", "x_fixed", "fixed"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    for f in ("offsets", "indices", "values", "objective_coefficients",
              "constraint_lower_bounds", "constraint_upper_bounds",
              "variable_lower_bounds", "variable_upper_bounds"):
        assert np.array_equal(getattr(a.problem, f), getattr(b.problem, f))
    assert a.problem.objective_offset == b.problem.objective_offset
    xr = rng.normal(size=len(a.keep))
    assert np.array_equal(a.postsolve(xr), b.postsolve(xr))
    xf = rng.normal(size=tp.n_variables)
    assert np.array_equal(a.project(xf), b.project(xf))


def _unnamed(p):
    """The problem as built field by field: no variable or row names."""
    return dataclasses.replace(p, variable_names=[], row_names=[])


def _fixed_twelve(P):
    """The twelve binaries with column 3 fixed to 1 by its bounds."""
    p = twelve_binaries(P)
    lb, ub = p.variable_lower_bounds.copy(), p.variable_upper_bounds.copy()
    lb[3] = ub[3] = 1.0
    return dataclasses.replace(p, variable_lower_bounds=lb,
                               variable_upper_bounds=ub)


@pytest.mark.parametrize("seed", range(4))
def test_eliminate_fixed_unnamed(seed):
    """Without names the reduction keeps none and builds the named
    problem's arrays."""
    tp = random_mip(seed)
    rng = np.random.default_rng(100 + seed)
    fix = rng.random(tp.n_variables) < 0.3
    lv = np.where(fix, 1.0, tp.variable_lower_bounds)
    uv = np.where(fix, 1.0, tp.variable_upper_bounds)
    a = T.eliminate_fixed(tp, lv, uv)
    b = T.eliminate_fixed(_unnamed(tp), lv, uv)
    assert a.problem.variable_names == [f"x{j}" for j in a.keep]
    assert b.problem.variable_names == [] and b.problem.row_names == []
    for f in ("offsets", "indices", "values", "objective_coefficients",
              "constraint_lower_bounds", "constraint_upper_bounds",
              "variable_lower_bounds", "variable_upper_bounds"):
        assert np.array_equal(getattr(a.problem, f), getattr(b.problem, f))
    assert np.array_equal(a.keep, b.keep)


def test_solve_mip_unnamed_with_fixed_column():
    """solve_mip on the unnamed twelve binaries whose presolve fixes a
    column: the named problem's status, objective and point."""
    s = MIPSolverSettings()
    s.time_limit = 30
    s.log_to_console = False
    named = _fixed_twelve(TProb)
    a = solve_mip(named, s, device="cpu")
    b = solve_mip(_unnamed(named), s, device="cpu")
    assert a.get_termination_status() == \
        TC.CUOPT_TERIMINATION_STATUS_OPTIMAL
    assert b.get_termination_status() == a.get_termination_status()
    assert b.get_primal_objective() == a.get_primal_objective() == \
        brute_force_min(named)
    assert np.array_equal(b.get_primal_solution(), a.get_primal_solution())
    # cuopt_tpu keeps the fault: its eliminate_fixed indexes the empty
    # name list (cuopt_tpu/mip/presolve.py:357)
    from cuopt_tpu.lp.settings import MIPSolverSettings as JSettings
    from cuopt_tpu.mip.solve import solve_mip as j_solve_mip

    js = JSettings()
    js.time_limit = 30
    js.log_to_console = False
    with pytest.raises(IndexError):
        j_solve_mip(_unnamed(_fixed_twelve(JProb)), js)


# ------------------------------------- test_mip_solver.py cases, on the port
def test_presolve_bound_propagation():
    # x + y <= 3, x >= 2  ->  y <= 1 (integers)
    offsets, indices = np.array([0, 2]), np.array([0, 1])
    values = np.array([1.0, 1.0])
    res = T.propagate_bounds(
        offsets, indices, values, np.array([-np.inf]), np.array([3.0]),
        np.array([2.0, 0.0]), np.array([np.inf, np.inf]),
        np.array([True, True]))
    assert not res.infeasible
    assert res.uv[1] <= 1.0 + 1e-9
    # infeasible: x + y <= 1 with x,y >= 1
    res2 = T.propagate_bounds(
        offsets, indices, values, np.array([-np.inf]), np.array([1.0]),
        np.array([1.0, 1.0]), np.array([np.inf, np.inf]),
        np.array([True, True]))
    assert res2.infeasible


def test_probing_fixes_implied_binary():
    """x + y >= 1.5 with x,y binary: probing x=0 forces y>=1.5 ->
    infeasible branch -> x fixed to 1 (and symmetrically y)."""
    r = T.probe_variables(
        np.array([0, 2]), np.array([0, 1]), np.array([1.0, 1.0]),
        np.array([1.5]), np.array([np.inf]), np.zeros(2), np.ones(2),
        np.array([True, True]))
    assert not r.infeasible
    assert r.n_fixed >= 1
    assert np.allclose(r.lv, [1.0, 1.0]) and np.allclose(r.uv, [1.0, 1.0])


def test_probing_detects_infeasible():
    """x + y >= 1.5 and x + y <= 0.5, binaries: both probe branches die."""
    r = T.probe_variables(
        np.array([0, 2, 4]), np.array([0, 1, 0, 1]), np.ones(4),
        np.array([1.5, -np.inf]), np.array([np.inf, 0.5]),
        np.zeros(2), np.ones(2), np.array([True, True]))
    assert r.infeasible


def test_trivial_presolve_eliminates_fixed_vars():
    """Variable elimination + CSR compaction: a MIP with presolve-fixable
    variables reaches the same optimum, reported in full user space."""
    A = np.array([[1.0, 0.0, 0.0], [1.0, 2.0, 3.0]])
    p = TProb.from_dense(
        A, c=np.array([1.0, -3.0, -4.0]),
        constraint_lower=np.array([-np.inf, -np.inf]),
        constraint_upper=np.array([np.inf, 6.0]),
        variable_lower=np.array([2.0, 0.0, 0.0]),
        variable_upper=np.array([2.0, 1.0, 1.0]),
        variable_types=np.array(["I", "I", "I"]))
    red = T.eliminate_fixed(p, p.variable_lower_bounds,
                            p.variable_upper_bounds)
    assert red is not None and len(red.keep) == 2
    assert red.problem.constraint_upper_bounds[1] == 4.0
    assert red.problem.objective_offset == 2.0
    s = MIPSolverSettings()
    s.time_limit = 30
    s.log_to_console = False
    sol = solve_mip(p, s, device="cpu")
    assert sol.get_termination_status() == \
        TC.CUOPT_TERIMINATION_STATUS_OPTIMAL
    x = sol.get_primal_solution()
    assert len(x) == 3 and abs(x[0] - 2.0) < 1e-6
    assert abs(sol.get_primal_objective() - (-2.0)) < 1e-6


def test_propagation_free_variable_rows():
    """Rows containing FREE variables must not produce implied bounds."""
    offsets, indices = np.array([0, 2]), np.array([0, 1])
    values = np.array([1.0, 1.0])
    res = T.propagate_bounds(
        offsets, indices, values, np.array([-np.inf]), np.array([5.0]),
        np.array([-np.inf, 0.0]), np.array([np.inf, 10.0]),
        np.array([False, False]))
    assert not res.infeasible
    assert res.uv[0] == 5.0 and not np.isfinite(res.lv[0])
    assert res.lv[1] == 0.0 and res.uv[1] == 10.0
    res2 = T.propagate_bounds(
        offsets, indices, values, np.array([-np.inf]), np.array([5.0]),
        np.array([-np.inf, -np.inf]), np.array([np.inf, np.inf]),
        np.array([False, False]))
    assert not res2.infeasible
    assert not np.isfinite(res2.uv).any()
    assert not np.isfinite(res2.lv).any()
