"""The host simplex's INFEASIBLE exits and its shortcut optimality claim,
in the port's patched copy of cpp/dual_simplex/simplex.cpp.

A free column that the cold start leaves over, or that rank repair
evicts, is parked fixed at 0; the source's two INFEASIBLE exits
(simplex.cpp:249 and :289) took a ray that holds only with those fake
bounds as a certificate, and its shortcut at :245 (a violation under
1e-6 with no entering candidate is optimal) answered under shifted costs.
The port's copy (cuopt_torch/kernels/build.py SIMPLEX_PATCHES) releases
the parked columns and restores the true costs first.

The LPs come from a seeded generator of small LPs with free and
duplicated columns. Each is feasible by construction (the rows' bounds
hold at a point x0 inside the column bounds), so an INFEASIBLE answer is
always wrong; the reference is scipy's HiGHS.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
from numpy import inf
from scipy.optimize import Bounds, LinearConstraint, linprog, milp

import cuopt_torch.dual_simplex.bindings as TB
from cuopt_torch import constants as C
from cuopt_torch.kernels import build
from cuopt_torch.lp.settings import MIPSolverSettings, PDLPSolverSettings
from cuopt_torch.mip.solve import solve_mip
from cuopt_torch.problem.mittelmann import _problem

# feasible LPs with a finite optimum on which the source's simplex says
# INFEASIBLE: "empty cand" at :249 for 549, "all cands flip" at :289 for
# 1606
EXIT_SEEDS = (549, 1606, 3066, 3192, 4323, 4916)
# an unbounded LP whose simplex takes the :245 shortcut under shifted
# costs (found among seeds 0-99,999)
SHORTCUT_SEED = 57522
# with its even columns integer, a MIP whose root LP the source's simplex
# calls INFEASIBLE, so solve_mip answers Infeasible (found among seeds
# 0-15,999)
MIP_SEED = 12398
_HIGHS_STATUS = {0: C.CUOPT_TERIMINATION_STATUS_OPTIMAL,
                 2: C.CUOPT_TERIMINATION_STATUS_INFEASIBLE,
                 3: C.CUOPT_TERIMINATION_STATUS_UNBOUNDED}


def generate(seed):
    """(M, lo, up, clo, cup, c, r, cc, v) of the seed's LP, or None where
    the generator skips the seed."""
    g = np.random.default_rng(seed)
    m = int(g.integers(3, 12)); n = int(g.integers(m, 3 * m))
    dens = g.uniform(0.2, 0.6)
    M = (g.random((m, n)) < dens) * np.round(g.normal(0, 2, (m, n)))
    k = int(g.integers(0, n // 2 + 1))
    for _ in range(k):
        a, b = g.integers(0, n, 2); M[:, b] = M[:, a] * g.choice([1, -1, 2])
    r, cc = np.nonzero(M); v = M[r, cc]
    if len(v) == 0: return None
    free = g.random(n) < 0.5
    clo = np.where(free, -inf, 0.0); cup = np.where(free, inf, g.choice([inf, 5.0], n))
    x0 = np.where(free, g.normal(0, 3, n), g.uniform(0, 2, n))
    ax = M @ x0
    kind = g.integers(0, 3, m)
    lo = np.where(kind == 0, ax, np.where(kind == 1, ax - g.uniform(0, 1, m), -inf))
    up = np.where(kind == 0, ax, np.where(kind == 1, inf, ax + g.uniform(0, 1, m)))
    if (np.abs(M).sum(1) == 0).any(): return None
    c = np.round(g.normal(0, 1, n), 2)
    return M, lo, up, clo, cup, c, r, cc, v


def highs(prob):
    """(cuopt status, objective or None) of a minimizing LP by scipy's
    HiGHS, its equality rows as A_eq."""
    A = sp.csr_matrix((prob.values, prob.indices, prob.offsets),
                      shape=(prob.n_constraints, prob.n_variables))
    lo, up = prob.constraint_lower_bounds, prob.constraint_upper_bounds
    eq = lo == up
    le, ge = ~eq & np.isfinite(up), ~eq & np.isfinite(lo)
    res = linprog(prob.objective_coefficients,
                  A_ub=sp.vstack([A[le], -A[ge]]),
                  b_ub=np.concatenate([up[le], -lo[ge]]),
                  A_eq=A[eq] if eq.any() else None,
                  b_eq=lo[eq] if eq.any() else None,
                  bounds=np.column_stack([prob.variable_lower_bounds,
                                          prob.variable_upper_bounds]),
                  method="highs")
    return _HIGHS_STATUS[res.status], res.fun


def problem(M, lo, up, clo, cup, c, r, cc, v):
    return _problem(lo, up, clo, cup, c, r, cc, v)


def port_solve(prob):
    return TB.solve_lp_simplex(prob, PDLPSolverSettings(), None)


def _agrees(raw, status, fun):
    if raw["status"] != status:
        return False
    return status != C.CUOPT_TERIMINATION_STATUS_OPTIMAL or \
        abs(raw["primal_objective"] - fun) <= 1e-6 * (1 + abs(fun))


def test_the_patched_copy_is_whole():
    """Each of SIMPLEX_PATCHES finds its text in simplex.cpp exactly
    `times` times."""
    assert build.simplex_source()[1] == []


@pytest.mark.parametrize("seed", EXIT_SEEDS)
def test_cuopt_tpu_says_infeasible(seed):
    """cuopt_tpu builds the unpatched source: its library keeps the
    fault."""
    pytest.importorskip("jax")
    from cuopt_tpu.dual_simplex.bindings import solve_lp_simplex
    from cuopt_tpu.lp.settings import PDLPSolverSettings as JSettings
    from cuopt_tpu.problem.mittelmann import _problem as j_problem

    M, lo, up, clo, cup, c, r, cc, v = generate(seed)
    assert highs(problem(M, lo, up, clo, cup, c, r, cc, v))[0] == \
        C.CUOPT_TERIMINATION_STATUS_OPTIMAL
    raw = solve_lp_simplex(j_problem(lo, up, clo, cup, c, r, cc, v),
                           JSettings(), None)
    assert raw["status"] == C.CUOPT_TERIMINATION_STATUS_INFEASIBLE


@pytest.mark.parametrize("seed", EXIT_SEEDS)
def test_the_port_reaches_the_optimum(seed):
    prob = problem(*generate(seed))
    status, fun = highs(prob)
    assert status == C.CUOPT_TERIMINATION_STATUS_OPTIMAL
    raw = port_solve(prob)
    assert raw["status"] == status
    assert abs(raw["primal_objective"] - fun) <= 1e-6 * (1 + abs(fun)), \
        (raw["primal_objective"], fun)


def test_a_thousand_seeds_agree_with_highs():
    """Status and objective of every LP of seeds 0-999 (about 2 s)."""
    wrong, solved = [], 0
    for seed in range(1000):
        data = generate(seed)
        if data is None:
            continue
        prob = problem(*data)
        status, fun = highs(prob)
        raw = port_solve(prob)
        solved += 1
        if not _agrees(raw, status, fun):
            wrong.append((seed, status, fun, raw["status"],
                          raw["primal_objective"]))
    assert solved > 700
    assert wrong == []


def _reduced_cost_gap(seed):
    M, lo, up, clo, cup, c, r, cc, v = generate(seed)
    raw = port_solve(problem(M, lo, up, clo, cup, c, r, cc, v))
    gap = np.abs(raw["reduced_cost"] - (c - M.T @ raw["dual_solution"]))
    return raw["status"], float(gap.max())


def _rebuild(monkeypatch, tmp_path, simplex_patches):
    """From here on, the port's simplex is built with these patches into
    `tmp_path` and loaded in this process."""
    monkeypatch.setattr(build, "SIMPLEX_PATCHES", simplex_patches)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(TB, "BUILDER", build.Builder())


def test_the_shortcut_answers_under_the_true_costs(monkeypatch, tmp_path):
    """The seed's simplex reaches the :245 shortcut with its costs
    shifted. The port reports UNBOUNDED, as HiGHS does, with reduced
    costs that are c - A^T y; a copy built without the shortcut's patch
    answers from the shortcut, with the shifted costs' reduced costs."""
    assert highs(problem(*generate(SHORTCUT_SEED)))[0] == \
        C.CUOPT_TERIMINATION_STATUS_UNBOUNDED
    status, gap = _reduced_cost_gap(SHORTCUT_SEED)
    assert status == C.CUOPT_TERIMINATION_STATUS_UNBOUNDED
    assert gap <= 1e-9
    without = tuple(p for p in build.SIMPLEX_PATCHES
                    if not p[0].lstrip().startswith("if (violation < 1e-6)"))
    assert len(without) == len(build.SIMPLEX_PATCHES) - 1
    _rebuild(monkeypatch, tmp_path, without)
    status, gap = _reduced_cost_gap(SHORTCUT_SEED)
    assert status == C.CUOPT_TERIMINATION_STATUS_UNBOUNDED
    assert gap > 0.5


def test_a_mip_keeps_the_optimum_the_source_prunes(monkeypatch, tmp_path):
    """B&B takes a node LP's INFEASIBLE as a prune: at the root it ends
    the solve. The port reaches scipy's milp optimum; built from the
    unpatched sources it answers Infeasible."""
    M, lo, up, clo, cup, c, r, cc, v = generate(MIP_SEED)
    integer = np.arange(len(c)) % 2 == 0
    want = milp(c, constraints=LinearConstraint(M, lo, up),
                integrality=integer, bounds=Bounds(clo, cup))
    assert want.status == 0
    # named columns: presolve's eliminate_fixed indexes variable_names
    # (ROADMAP Queue 3)
    prob = dataclasses.replace(
        problem(M, lo, up, clo, cup, c, r, cc, v),
        variable_types=np.where(integer, "I", "C"),
        variable_names=[f"x{j}" for j in range(len(c))])

    def solve():
        s = MIPSolverSettings()
        s.time_limit = 20.0
        s.log_to_console = False
        return solve_mip(prob, s, device="cpu")

    sol = solve()
    assert sol.get_termination_reason() == "Optimal"
    assert abs(sol.get_primal_objective() - want.fun) <= \
        1e-6 * (1 + abs(want.fun))
    _rebuild(monkeypatch, tmp_path, ())
    assert solve().get_termination_reason() == "Infeasible"
