"""C-API-shaped interface.

Function-for-function mirror of the reference C API
(cpp/include/cuopt/linear_programming/cuopt_c.h:106-668, impl
cuopt_c.cpp): opaque handles cuOptOptimizationProblem /
cuOptSolverSettings / cuOptSolution, status-code returns, out-parameter
style via mutable containers. Counterpart of cuopt_tpu/c_api.py, and the
implementation behind the port's build of the C ABI (cpp/c_api/cuopt_c.c
through c_api_embed.py); the C side only marshals. cuOptSolve runs on the
device CUOPT_TORCH_DEVICE names (utils/device.py): the card unless it says
"cpu".

All functions return a cuopt_int_t status (CUOPT_SUCCESS /
CUOPT_INVALID_ARGUMENT / ...) and write results through `out` lists (the
Python stand-in for out-pointers).
"""

from __future__ import annotations

import numpy as np

from cuopt_torch import constants as C
from cuopt_torch.io.mps_parser import parse_mps
from cuopt_torch.lp.settings import SolverSettings
from cuopt_torch.problem.data_model import OptimizationProblem
from cuopt_torch.utils.errors import CuOptTorchError, MpsParseError

__all__ = [n for n in dir() if n.startswith("cuOpt")]


class cuOptOptimizationProblem:
    def __init__(self, prob: OptimizationProblem):
        self.prob = prob


class cuOptSolverSettings:
    def __init__(self):
        self.settings = SolverSettings()


class cuOptSolution:
    def __init__(self, solution):
        self.solution = solution


def _set(out, value):
    if isinstance(out, list):
        out.clear()
        out.append(value)
    elif isinstance(out, np.ndarray):
        np.copyto(out, value)
    else:
        raise TypeError("out parameter must be list or ndarray")


# ------------------------------------------------------ problem lifecycle
def cuOptReadProblem(filename, problem_out) -> int:
    """cuopt_c.h: cuOptReadProblem — parse an MPS file."""
    try:
        prob = parse_mps(str(filename))
    except MpsParseError:
        return C.CUOPT_MPS_FILE_ERROR
    except OSError:
        return C.CUOPT_MPS_FILE_ERROR
    _set(problem_out, cuOptOptimizationProblem(prob))
    return C.CUOPT_SUCCESS


def cuOptCreateProblem(
    num_constraints, num_variables, objective_sense, objective_offset,
    objective_coefficients, constraint_matrix_row_offsets,
    constraint_matrix_column_indices, constraint_matrix_coefficients,
    constraint_sense, rhs, lower_bounds, upper_bounds, variable_types,
    problem_out,
) -> int:
    """cuopt_c.h:151 — row-type + rhs form."""
    try:
        from cuopt_torch.problem.data_model import DataModel

        dm = DataModel()
        dm.set_csr_constraint_matrix(
            constraint_matrix_coefficients,
            constraint_matrix_column_indices,
            constraint_matrix_row_offsets,
        )
        dm.set_objective_coefficients(objective_coefficients)
        dm.set_objective_offset(objective_offset)
        dm.set_maximize(objective_sense == C.CUOPT_MAXIMIZE)
        dm.set_row_types([chr(s) if isinstance(s, int) else s
                          for s in constraint_sense])
        dm.set_constraint_bounds(rhs)
        if lower_bounds is not None:
            dm.set_variable_lower_bounds(lower_bounds)
        if upper_bounds is not None:
            dm.set_variable_upper_bounds(upper_bounds)
        if variable_types is not None:
            dm.set_variable_types(
                [chr(t) if isinstance(t, int) else t
                 for t in variable_types]
            )
        _set(problem_out, cuOptOptimizationProblem(dm.to_problem()))
        return C.CUOPT_SUCCESS
    except CuOptTorchError:
        return C.CUOPT_INVALID_ARGUMENT


def cuOptCreateRangedProblem(
    num_constraints, num_variables, objective_sense, objective_offset,
    objective_coefficients, constraint_matrix_row_offsets,
    constraint_matrix_column_indices, constraint_matrix_coefficients,
    constraint_lower_bounds, constraint_upper_bounds,
    variable_lower_bounds, variable_upper_bounds, variable_types,
    problem_out,
) -> int:
    """cuopt_c.h:220 — two-sided constraint form."""
    try:
        from cuopt_torch.problem.data_model import DataModel

        dm = DataModel()
        dm.set_csr_constraint_matrix(
            constraint_matrix_coefficients,
            constraint_matrix_column_indices,
            constraint_matrix_row_offsets,
        )
        dm.set_objective_coefficients(objective_coefficients)
        dm.set_objective_offset(objective_offset)
        dm.set_maximize(objective_sense == C.CUOPT_MAXIMIZE)
        dm.set_constraint_lower_bounds(constraint_lower_bounds)
        dm.set_constraint_upper_bounds(constraint_upper_bounds)
        if variable_lower_bounds is not None:
            dm.set_variable_lower_bounds(variable_lower_bounds)
        if variable_upper_bounds is not None:
            dm.set_variable_upper_bounds(variable_upper_bounds)
        if variable_types is not None:
            dm.set_variable_types(
                [chr(t) if isinstance(t, int) else t
                 for t in variable_types]
            )
        _set(problem_out, cuOptOptimizationProblem(dm.to_problem()))
        return C.CUOPT_SUCCESS
    except CuOptTorchError:
        return C.CUOPT_INVALID_ARGUMENT


def cuOptDestroyProblem(problem) -> int:
    if isinstance(problem, list):
        problem.clear()
    return C.CUOPT_SUCCESS


# -------------------------------------------------------- problem getters
def _prob(problem):
    return problem.prob if isinstance(problem, cuOptOptimizationProblem) \
        else problem[0].prob


def cuOptGetNumConstraints(problem, out) -> int:
    _set(out, _prob(problem).n_constraints)
    return C.CUOPT_SUCCESS


def cuOptGetNumVariables(problem, out) -> int:
    _set(out, _prob(problem).n_variables)
    return C.CUOPT_SUCCESS


def cuOptGetNumNonZeros(problem, out) -> int:
    _set(out, _prob(problem).nnz)
    return C.CUOPT_SUCCESS


def cuOptGetObjectiveSense(problem, out) -> int:
    _set(out, C.CUOPT_MAXIMIZE if _prob(problem).maximize
         else C.CUOPT_MINIMIZE)
    return C.CUOPT_SUCCESS


def cuOptGetObjectiveOffset(problem, out) -> int:
    _set(out, _prob(problem).objective_offset)
    return C.CUOPT_SUCCESS


def cuOptGetObjectiveCoefficients(problem, out) -> int:
    _set(out, np.asarray(_prob(problem).objective_coefficients))
    return C.CUOPT_SUCCESS


def cuOptGetConstraintMatrix(problem, offsets_out, indices_out,
                             values_out) -> int:
    p = _prob(problem)
    _set(offsets_out, np.asarray(p.offsets))
    _set(indices_out, np.asarray(p.indices))
    _set(values_out, np.asarray(p.values))
    return C.CUOPT_SUCCESS


def cuOptGetConstraintSense(problem, out) -> int:
    _set(out, np.asarray(_prob(problem).row_types))
    return C.CUOPT_SUCCESS


def cuOptGetConstraintRightHandSide(problem, out) -> int:
    _set(out, np.asarray(_prob(problem).rhs))
    return C.CUOPT_SUCCESS


def cuOptGetConstraintLowerBounds(problem, out) -> int:
    _set(out, np.asarray(_prob(problem).constraint_lower_bounds))
    return C.CUOPT_SUCCESS


def cuOptGetConstraintUpperBounds(problem, out) -> int:
    _set(out, np.asarray(_prob(problem).constraint_upper_bounds))
    return C.CUOPT_SUCCESS


def cuOptGetVariableLowerBounds(problem, out) -> int:
    _set(out, np.asarray(_prob(problem).variable_lower_bounds))
    return C.CUOPT_SUCCESS


def cuOptGetVariableUpperBounds(problem, out) -> int:
    _set(out, np.asarray(_prob(problem).variable_upper_bounds))
    return C.CUOPT_SUCCESS


def cuOptGetVariableTypes(problem, out) -> int:
    _set(out, np.asarray(_prob(problem).variable_types))
    return C.CUOPT_SUCCESS


def cuOptIsMIP(problem, out) -> int:
    _set(out, int(_prob(problem).is_mip()))
    return C.CUOPT_SUCCESS


# -------------------------------------------------------------- settings
def cuOptCreateSolverSettings(settings_out) -> int:
    _set(settings_out, cuOptSolverSettings())
    return C.CUOPT_SUCCESS


def cuOptDestroySolverSettings(settings) -> int:
    if isinstance(settings, list):
        settings.clear()
    return C.CUOPT_SUCCESS


def _settings(s):
    return s.settings if isinstance(s, cuOptSolverSettings) else \
        s[0].settings


def cuOptSetParameter(settings, name, value) -> int:
    try:
        _settings(settings).set_parameter(str(name), value)
        return C.CUOPT_SUCCESS
    except CuOptTorchError:
        return C.CUOPT_INVALID_ARGUMENT


def cuOptGetParameter(settings, name, out) -> int:
    try:
        _set(out, str(_settings(settings).get_parameter(str(name))))
        return C.CUOPT_SUCCESS
    except CuOptTorchError:
        return C.CUOPT_INVALID_ARGUMENT


def cuOptSetFloatParameter(settings, name, value) -> int:
    return cuOptSetParameter(settings, name, float(value))


def cuOptSetIntegerParameter(settings, name, value) -> int:
    return cuOptSetParameter(settings, name, int(value))


def cuOptGetFloatParameter(settings, name, out) -> int:
    try:
        _set(out, float(_settings(settings).get_parameter(str(name))))
        return C.CUOPT_SUCCESS
    except (CuOptTorchError, ValueError, TypeError):
        return C.CUOPT_INVALID_ARGUMENT


def cuOptGetIntegerParameter(settings, name, out) -> int:
    try:
        _set(out, int(_settings(settings).get_parameter(str(name))))
        return C.CUOPT_SUCCESS
    except (CuOptTorchError, ValueError, TypeError):
        return C.CUOPT_INVALID_ARGUMENT


# ----------------------------------------------------------------- solve
def cuOptSolve(problem, settings, solution_out) -> int:
    """cuopt_c.h:546 — dispatches LP vs MIP via cuOptIsMIP (:533)."""
    from cuopt_torch.linear_programming import Solve
    from cuopt_torch.utils.device import entry_device

    try:
        sol = Solve(_prob(problem), _settings(settings), entry_device())
    except CuOptTorchError:
        return C.CUOPT_INVALID_ARGUMENT
    _set(solution_out, cuOptSolution(sol))
    return C.CUOPT_SUCCESS


def cuOptDestroySolution(solution) -> int:
    if isinstance(solution, list):
        solution.clear()
    return C.CUOPT_SUCCESS


# ------------------------------------------------------ solution getters
def _sol(s):
    return s.solution if isinstance(s, cuOptSolution) else s[0].solution


def cuOptGetTerminationStatus(solution, out) -> int:
    _set(out, _sol(solution).get_termination_status())
    return C.CUOPT_SUCCESS


def cuOptGetObjectiveValue(solution, out) -> int:
    _set(out, _sol(solution).get_primal_objective())
    return C.CUOPT_SUCCESS


def cuOptGetPrimalSolution(solution, out) -> int:
    _set(out, np.asarray(_sol(solution).get_primal_solution()))
    return C.CUOPT_SUCCESS


def cuOptGetDualSolution(solution, out) -> int:
    d = _sol(solution).get_dual_solution()
    if d is None:
        return C.CUOPT_INVALID_ARGUMENT
    _set(out, np.asarray(d))
    return C.CUOPT_SUCCESS


def cuOptGetReducedCosts(solution, out) -> int:
    r = _sol(solution).get_reduced_costs()
    if r is None:
        return C.CUOPT_INVALID_ARGUMENT
    _set(out, np.asarray(r))
    return C.CUOPT_SUCCESS


def cuOptGetSolveTime(solution, out) -> int:
    _set(out, _sol(solution).get_solve_time())
    return C.CUOPT_SUCCESS


def cuOptGetMIPGap(solution, out) -> int:
    _set(out, _sol(solution).get_mip_gap())
    return C.CUOPT_SUCCESS


def cuOptGetSolutionBound(solution, out) -> int:
    _set(out, _sol(solution).get_solution_bound())
    return C.CUOPT_SUCCESS


# ---------------------------------------------------------------- errors
def cuOptGetErrorStatus(status) -> int:
    return int(status)


_ERROR_STRINGS = {
    C.CUOPT_SUCCESS: "Success",
    C.CUOPT_INVALID_ARGUMENT: "Invalid argument",
    C.CUOPT_MPS_FILE_ERROR: "MPS file error",
    C.CUOPT_VALIDATION_ERROR: "Validation error",
    C.CUOPT_OUT_OF_MEMORY: "Out of memory",
    C.CUOPT_RUNTIME_ERROR: "Runtime error",
}


def cuOptGetErrorString(status) -> str:
    return _ERROR_STRINGS.get(int(status), "Unknown error")


def cuOptGetIntSize() -> int:
    return 4


def cuOptGetFloatSize() -> int:
    return 8
