"""Incumbent-callback base classes.

API parity with the reference
python/cuopt/cuopt/linear_programming/internals/internals.py:28-79
(`GetSolutionCallback` receives each new incumbent; `SetSolutionCallback`
lets the user inject solutions into the running solver). Wired through
`MIPSolverSettings.set_mip_callback` (reference solver_settings.py:241) and
invoked from the MIP population loop (reference
cpp/src/mip/diversity/population.cuh run_solution_callbacks :142).
"""

from __future__ import annotations


class Callback:
    """Base marker for MIP callbacks."""


class GetSolutionCallback(Callback):
    """Subclass and override get_solution(solution, solution_cost).

    solution: 1-D numpy array (a copy of the incumbent assignment).
    solution_cost: 1-element numpy array with the objective value.
    """

    def get_solution(self, solution, solution_cost):  # pragma: no cover
        raise NotImplementedError


class SetSolutionCallback(Callback):
    """Subclass and override set_solution(solution, solution_cost).

    The solver polls this; write a candidate assignment into `solution`
    (1-D numpy array, prefilled with the current best or NaN) and its
    objective into solution_cost[0] to inject it.
    """

    def set_solution(self, solution, solution_cost):  # pragma: no cover
        raise NotImplementedError
