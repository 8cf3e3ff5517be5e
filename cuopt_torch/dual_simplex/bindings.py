"""ctypes bindings for the native dual simplex (cpp/dual_simplex).

Counterpart of cuopt_tpu/dual_simplex/bindings.py, which mirrors the
reference dual_simplex entry `solve_linear_program`
(cpp/src/dual_simplex/solve.hpp:52-74). Both packages build the same
source into the same machine code, each into a library of its own: this
one into cuopt_torch/_build/ (kernels/build.py), whose options are its
own even in a process that has loaded cuopt_tpu's too. A missing g++ or a
failed build raises.

Host only: numpy in, numpy out.
"""

from __future__ import annotations

import ctypes
import math
import threading

import numpy as np

from cuopt_torch import constants as C
from cuopt_torch.kernels.build import BUILDER
from cuopt_torch.sparse.ops import _transpose_csr

# native status codes (cpp/dual_simplex/simplex.cpp Status)
DS_OPTIMAL = 0
DS_INFEASIBLE = 1
DS_UNBOUNDED = 2
DS_ITER_LIMIT = 3
DS_TIME_LIMIT = 4
DS_NUMERICAL = 5
DS_HALTED = 6

_STATUS_MAP = {
    DS_OPTIMAL: C.CUOPT_TERIMINATION_STATUS_OPTIMAL,
    DS_INFEASIBLE: C.CUOPT_TERIMINATION_STATUS_INFEASIBLE,
    DS_UNBOUNDED: C.CUOPT_TERIMINATION_STATUS_UNBOUNDED,
    DS_ITER_LIMIT: C.CUOPT_TERIMINATION_STATUS_ITERATION_LIMIT,
    DS_TIME_LIMIT: C.CUOPT_TERIMINATION_STATUS_TIME_LIMIT,
    DS_NUMERICAL: C.CUOPT_TERIMINATION_STATUS_NUMERICAL_ERROR,
    DS_HALTED: C.CUOPT_TERIMINATION_STATUS_CONCURRENT_LIMIT,
}

_I64 = np.ctypeslib.ndpointer(np.int64)
_F64 = np.ctypeslib.ndpointer(np.float64)
_C_INT, _C_DOUBLE, _VOID_P = ctypes.c_int, ctypes.c_double, ctypes.c_void_p

# (restype, argtypes) of each entry point, in the order of the extern "C"
# prototypes at the bottom of cpp/dual_simplex/simplex.cpp
SIGNATURES = {
    "ds_solve_adv": (_C_INT, [
        _C_INT, _C_INT,              # m, n
        _I64, _I64, _F64,            # CSC col_ptr, row_ind, values
        _F64, _F64, _F64, _F64, _F64,  # c, var_lo, var_up, row_lo, row_up
        _C_DOUBLE, _C_INT,           # time_limit, iter_limit
        _VOID_P,                     # halt (int*) or NULL
        _VOID_P,                     # vstat_in (int8*) or NULL
        _VOID_P,                     # x_hint (double*) or NULL
        _VOID_P,                     # y_hint (double*) or NULL
        _F64, _F64, _F64,            # x_out, y_out, dj_out
        ctypes.POINTER(_C_DOUBLE),   # obj_out
        ctypes.POINTER(_C_INT),      # iters_out
        _VOID_P,                     # vstat_out (int8*) or NULL
    ]),
    "ds_set_options": (None, [_C_DOUBLE, _C_DOUBLE, _C_DOUBLE, _C_INT,
                              _C_DOUBLE]),
    "ds_last_used_big_bounds": (_C_INT, []),
    "ds_get_options": (None, [_F64]),
    # ds_solve, the cold-start entry kept for older callers, is
    # ds_solve_adv without warm start: not bound here
}


_TYPES_LOCK = threading.Lock()


def load_library() -> ctypes.CDLL:
    """The simplex library, built on first use, with every entry point's
    types declared once: setting a function's argtypes while another
    thread (strong branching's pool) is inside a call to it corrupts the
    converters that call is reading."""
    lib = BUILDER.simplex_library()
    with _TYPES_LOCK:
        if not getattr(lib, "_cuopt_torch_typed", False):
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            lib._cuopt_torch_typed = True
    return lib


def solve_lp_simplex(prob, settings, timer, halt=None, vstat=None,
                     x_hint=None, y_hint=None, want_vstat=False):
    """Solve with the native dual simplex. Returns the raw solution dict
    (same schema as PdlpSolver.run).

    halt: optional ctypes pointer to an int that the simplex polls every
    32 pivots; nonzero stops it with status CONCURRENT_LIMIT. vstat:
    optional int8[n+m] warm basis statuses (0 lower / 1 upper / 2 basic)
    from a previous solve (B&B node re-solves). x_hint/y_hint: optional
    PDLP point for crossover placements (user sense; converted to minimize
    space here). want_vstat: include final basis statuses in the result
    under "vstat"."""
    lib = load_library()
    n, m = prob.n_variables, prob.n_constraints
    t_off, t_idx, t_val, _ = _transpose_csr(
        prob.offsets, prob.indices, prob.values, m, n)
    sign = -1.0 if prob.maximize else 1.0
    c = np.ascontiguousarray(sign * prob.objective_coefficients, np.float64)
    x = np.zeros(n)
    y = np.zeros(m)
    dj = np.zeros(n)
    obj = ctypes.c_double()
    iters = ctypes.c_int()
    halt_ptr = ctypes.cast(halt, ctypes.c_void_p) if halt is not None \
        else None
    tl = timer.remaining() if timer is not None else math.inf
    # settings.time_limit caps the solve too (a caller may give the simplex
    # a budget of its own on top of the global clock)
    s_tl = getattr(settings, "time_limit", math.inf)
    if s_tl:
        tl = min(tl, s_tl)
    if not math.isfinite(tl):
        tl = 1e18

    def _opt_ptr(arr, dtype):
        # the array is kept in the returned pair while the call runs
        if arr is None:
            return None
        a = np.ascontiguousarray(arr, dtype)
        return (a, a.ctypes.data_as(ctypes.c_void_p))

    vstat_in = _opt_ptr(vstat, np.int8)
    xh = _opt_ptr(x_hint, np.float64)
    # y hint converted to minimize space (the native core minimizes)
    yh = _opt_ptr(
        None if y_hint is None else sign * np.asarray(y_hint, np.float64),
        np.float64)
    vstat_out = np.zeros(n + m, np.int8) if want_vstat else None

    status = lib.ds_solve_adv(
        m, n,
        np.ascontiguousarray(t_off, np.int64),
        np.ascontiguousarray(t_idx, np.int64),
        np.ascontiguousarray(t_val, np.float64),
        c,
        np.ascontiguousarray(prob.variable_lower_bounds, np.float64),
        np.ascontiguousarray(prob.variable_upper_bounds, np.float64),
        np.ascontiguousarray(prob.constraint_lower_bounds, np.float64),
        np.ascontiguousarray(prob.constraint_upper_bounds, np.float64),
        float(tl),
        int(min(getattr(settings, "iteration_limit", 1 << 30), 1 << 30)),
        halt_ptr,
        None if vstat_in is None else vstat_in[1],
        None if xh is None else xh[1],
        None if yh is None else yh[1],
        x, y, dj, ctypes.byref(obj), ctypes.byref(iters),
        None if vstat_out is None else
        vstat_out.ctypes.data_as(ctypes.c_void_p),
    )
    primal_obj = obj.value + sign * prob.objective_offset
    raw = {
        "status": _STATUS_MAP.get(status,
                                  C.CUOPT_TERIMINATION_STATUS_NUMERICAL_ERROR),
        "iterations": iters.value,
        "attempts": iters.value,
        "solve_time": timer.elapsed() if timer is not None else 0.0,
        "primal_solution": x,
        "dual_solution": sign * y,
        "reduced_cost": sign * dj,
        "primal_objective": sign * primal_obj,
        "dual_objective": sign * primal_obj,
        "gap": 0.0,
        "l2_primal_residual": 0.0,
        "l2_dual_residual": 0.0,
        "linf_primal_residual": 0.0,
        "linf_dual_residual": 0.0,
        "solved_by": "dual_simplex",
    }
    if vstat_out is not None:
        raw["vstat"] = vstat_out
    return raw


def set_simplex_options(pivot_tolerance=None, primal_feasibility_tolerance=None,
                        dual_feasibility_tolerance=None,
                        refactor_frequency=None, big_bound=None):
    """Configure this package's native simplex (reference
    simplex_solver_settings.hpp:35-67 exposes the same knobs). Unset
    fields keep their current values. Set before solving; concurrent
    solves share the options."""
    load_library().ds_set_options(
        -1.0 if pivot_tolerance is None else float(pivot_tolerance),
        -1.0 if primal_feasibility_tolerance is None
        else float(primal_feasibility_tolerance),
        -1.0 if dual_feasibility_tolerance is None
        else float(dual_feasibility_tolerance),
        -1 if refactor_frequency is None else int(refactor_frequency),
        -1.0 if big_bound is None else float(big_bound),
    )


def last_used_big_bounds() -> bool:
    """Whether the LAST native solve in this process fell back to
    temporary big bounds for a free column (the reference's phase-1
    territory, dual_simplex/phase1.cpp; free columns enter the initial
    basis instead, so this should stay False)."""
    return bool(load_library().ds_last_used_big_bounds())


def get_simplex_options() -> dict:
    out = np.zeros(5)
    load_library().ds_get_options(out)
    return {
        "pivot_tolerance": out[0],
        "primal_feasibility_tolerance": out[1],
        "dual_feasibility_tolerance": out[2],
        "refactor_frequency": int(out[3]),
        "big_bound": out[4],
    }
