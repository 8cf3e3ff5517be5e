"""Public LP/MIP API, mirroring the reference Python package
`cuopt.linear_programming` (python/cuopt/cuopt/linear_programming/):
DataModel, SolverSettings, Solve, BatchSolve, Solution.

Counterpart of cuopt_tpu/linear_programming/__init__.py. `Solve` and
`BatchSolve` run on `device`, "cuda" unless the caller asks for "cpu";
without a card a "cuda" solve raises, whatever its method.
"""

from __future__ import annotations

import torch

from cuopt_torch import constants  # noqa: F401
from cuopt_torch.io.mps_parser import ParseMps  # noqa: F401
from cuopt_torch.lp.settings import (  # noqa: F401
    MIPSolverSettings,
    PDLPSolverSettings,
    SolverSettings,
)
from cuopt_torch.lp.solution import Solution  # noqa: F401
from cuopt_torch.problem.data_model import DataModel  # noqa: F401


def _as_problem(data_model):
    from cuopt_torch.problem.data_model import OptimizationProblem

    if isinstance(data_model, OptimizationProblem):
        return data_model
    return data_model.to_problem()


def Solve(data_model, solver_settings=None, device="cuda"):
    """Solve an LP or MIP (reference solver/solver.py:22 `Solve`).

    Dispatches on variable types like the reference cuOptSolve
    (cuopt_c.cpp cuOptIsMIP :533)."""
    torch.empty(0, device=device)  # no card: raises here, not later
    prob = _as_problem(data_model)
    if solver_settings is None:
        solver_settings = SolverSettings()
    if isinstance(solver_settings, SolverSettings):
        lp_settings = solver_settings.pdlp
        mip_settings = solver_settings.mip
    elif isinstance(solver_settings, PDLPSolverSettings):
        lp_settings, mip_settings = solver_settings, MIPSolverSettings()
    else:
        lp_settings, mip_settings = PDLPSolverSettings(), solver_settings
    if prob.is_mip():
        from cuopt_torch.mip.solve import solve_mip

        return solve_mip(prob, mip_settings, device)
    from cuopt_torch.lp.solve import solve_lp

    return solve_lp(prob, lp_settings, device)


def BatchSolve(data_models, solver_settings=None, device="cuda"):
    """Solve a batch of LPs (reference solver.py:101 BatchSolve;
    cython_solve.cu call_batch_solve :264) as one stacked program when
    their shapes align, otherwise one by one."""
    from cuopt_torch.lp.batch import batch_solve

    probs = [_as_problem(dm) for dm in data_models]
    if solver_settings is None:
        solver_settings = SolverSettings()
    lp = solver_settings.pdlp if isinstance(
        solver_settings, SolverSettings
    ) else solver_settings
    return batch_solve(probs, lp, device)
