"""Embedding bridge for the C ABI (cpp/c_api/cuopt_c.c).

Counterpart of cuopt_tpu/c_api_embed.py. The port's build of the C ABI,
libcuopt_torch_c-<hash>.so (kernels/build.py `Builder.capi_library()`),
embeds a Python interpreter, or takes the one it is loaded into, and
forwards every cuOpt* call here (reference: cuopt_c.cpp implements the same ~40
functions natively over the C++ engine, cuopt_c.h:106-668). Handles are
integer ids into a registry so the C side never touches PyObjects;
array inputs arrive as raw addresses (read via ctypes), array outputs
leave as bytes.

`load_library()` is the other direction: the library itself through
ctypes, with every prototype of cpp/include/cuopt_c.h declared once, for
Python callers of the C ABI.
"""

from __future__ import annotations

import ctypes
import itertools
import threading

import numpy as np

from cuopt_torch import c_api as A
from cuopt_torch import constants as C

_registry: dict[int, object] = {}
_ids = itertools.count(1)  # next() is atomic: callers may be threads


def _put(obj) -> int:
    h = next(_ids)
    _registry[h] = obj
    return h


def _arr(addr: int, n: int, ctype):
    if addr == 0 or n == 0:
        return np.zeros(0, np.float64 if ctype is ctypes.c_double
                        else np.int32)
    buf = (ctype * n).from_address(addr)
    return np.ctypeslib.as_array(buf).copy()


def _chars(addr: int, n: int) -> np.ndarray:
    if addr == 0 or n == 0:  # NULL from a C caller must not segfault
        return np.zeros(0, dtype="U1")
    raw = (ctypes.c_char * n).from_address(addr).raw
    return np.frombuffer(raw, dtype="S1").astype("U1")


def read_problem(path: str):
    out = []
    st = A.cuOptReadProblem(path, out)
    return int(st), (_put(out[0]) if st == C.CUOPT_SUCCESS else 0)


def create_problem(nc, nv, sense, offset, a_obj, a_off, a_idx, a_val,
                   a_sense, a_rhs, a_lb, a_ub, a_vt, nnz):
    out = []
    st = A.cuOptCreateProblem(
        nc, nv, sense, offset,
        _arr(a_obj, nv, ctypes.c_double),
        _arr(a_off, nc + 1, ctypes.c_int32),
        _arr(a_idx, nnz, ctypes.c_int32),
        _arr(a_val, nnz, ctypes.c_double),
        _chars(a_sense, nc),
        _arr(a_rhs, nc, ctypes.c_double),
        _arr(a_lb, nv, ctypes.c_double),
        _arr(a_ub, nv, ctypes.c_double),
        _chars(a_vt, nv),
        out,
    )
    return int(st), (_put(out[0]) if st == C.CUOPT_SUCCESS else 0)


def create_ranged_problem(nc, nv, sense, offset, a_obj, a_off, a_idx,
                          a_val, a_clb, a_cub, a_lb, a_ub, a_vt, nnz):
    out = []
    st = A.cuOptCreateRangedProblem(
        nc, nv, sense, offset,
        _arr(a_obj, nv, ctypes.c_double),
        _arr(a_off, nc + 1, ctypes.c_int32),
        _arr(a_idx, nnz, ctypes.c_int32),
        _arr(a_val, nnz, ctypes.c_double),
        _arr(a_clb, nc, ctypes.c_double),
        _arr(a_cub, nc, ctypes.c_double),
        _arr(a_lb, nv, ctypes.c_double),
        _arr(a_ub, nv, ctypes.c_double),
        _chars(a_vt, nv),
        out,
    )
    return int(st), (_put(out[0]) if st == C.CUOPT_SUCCESS else 0)


def destroy(handle: int):
    _registry.pop(handle, None)
    return C.CUOPT_SUCCESS


_PROB_SCALARS = {
    "num_constraints": A.cuOptGetNumConstraints,
    "num_variables": A.cuOptGetNumVariables,
    "num_nonzeros": A.cuOptGetNumNonZeros,
    "objective_sense": A.cuOptGetObjectiveSense,
    "objective_offset": A.cuOptGetObjectiveOffset,
    "is_mip": A.cuOptIsMIP,
}


def prob_scalar(handle: int, what: str):
    out = []
    st = _PROB_SCALARS[what](_registry[handle], out)
    return int(st), float(out[0])


_PROB_ARRAYS = {
    "objective_coefficients": (A.cuOptGetObjectiveCoefficients, "f8"),
    "constraint_lower_bounds": (A.cuOptGetConstraintLowerBounds, "f8"),
    "constraint_upper_bounds": (A.cuOptGetConstraintUpperBounds, "f8"),
    "variable_lower_bounds": (A.cuOptGetVariableLowerBounds, "f8"),
    "variable_upper_bounds": (A.cuOptGetVariableUpperBounds, "f8"),
    "rhs": (A.cuOptGetConstraintRightHandSide, "f8"),
}


def prob_array(handle: int, what: str):
    fn, dt = _PROB_ARRAYS[what]
    out = []
    st = fn(_registry[handle], out)
    if st != C.CUOPT_SUCCESS:
        return int(st), b""
    return int(st), np.asarray(out[0], dt).tobytes()


def prob_matrix(handle: int):
    o, i, v = [], [], []
    st = A.cuOptGetConstraintMatrix(_registry[handle], o, i, v)
    if st != C.CUOPT_SUCCESS:
        return int(st), b"", b"", b""
    return (int(st), np.asarray(o[0], np.int32).tobytes(),
            np.asarray(i[0], np.int32).tobytes(),
            np.asarray(v[0], np.float64).tobytes())


def prob_types(handle: int, what: str):
    out = []
    fn = A.cuOptGetVariableTypes if what == "variable_types" \
        else A.cuOptGetConstraintSense
    st = fn(_registry[handle], out)
    if st != C.CUOPT_SUCCESS:
        return int(st), b""
    return int(st), "".join(
        x if isinstance(x, str) else x.decode() for x in out[0]
    ).encode()


def create_settings():
    out = []
    st = A.cuOptCreateSolverSettings(out)
    return int(st), (_put(out[0]) if st == C.CUOPT_SUCCESS else 0)


def set_parameter(h: int, name: str, value: str):
    return int(A.cuOptSetParameter(_registry[h], name, value))


def get_parameter(h: int, name: str):
    out = []
    st = A.cuOptGetParameter(_registry[h], name, out)
    return int(st), (str(out[0]) if st == C.CUOPT_SUCCESS else "")


def set_float_parameter(h: int, name: str, value: float):
    return int(A.cuOptSetFloatParameter(_registry[h], name, value))


def set_integer_parameter(h: int, name: str, value: int):
    return int(A.cuOptSetIntegerParameter(_registry[h], name, value))


def get_float_parameter(h: int, name: str):
    out = []
    st = A.cuOptGetFloatParameter(_registry[h], name, out)
    return int(st), (float(out[0]) if st == C.CUOPT_SUCCESS else 0.0)


def get_integer_parameter(h: int, name: str):
    out = []
    st = A.cuOptGetIntegerParameter(_registry[h], name, out)
    return int(st), (int(out[0]) if st == C.CUOPT_SUCCESS else 0)


def solve(prob_h: int, settings_h: int):
    out = []
    st = A.cuOptSolve(_registry[prob_h], _registry[settings_h], out)
    return int(st), (_put(out[0]) if out else 0)


_SOL_SCALARS = {
    "termination_status": A.cuOptGetTerminationStatus,
    "objective_value": A.cuOptGetObjectiveValue,
    "solve_time": A.cuOptGetSolveTime,
    "mip_gap": A.cuOptGetMIPGap,
    "solution_bound": A.cuOptGetSolutionBound,
}


def sol_scalar(h: int, what: str):
    out = []
    st = _SOL_SCALARS[what](_registry[h], out)
    return int(st), float(out[0]) if out else 0.0


_SOL_ARRAYS = {
    "primal_solution": A.cuOptGetPrimalSolution,
    "dual_solution": A.cuOptGetDualSolution,
    "reduced_costs": A.cuOptGetReducedCosts,
}


def sol_array(h: int, what: str):
    out = []
    st = _SOL_ARRAYS[what](_registry[h], out)
    if st != C.CUOPT_SUCCESS or not out or out[0] is None:
        return int(st), b""
    return int(st), np.asarray(out[0], np.float64).tobytes()


# ------------------------------------------- the library through ctypes
_INT, _FLT, _H = ctypes.c_int32, ctypes.c_double, ctypes.c_void_p
_PH, _PI, _PF = (ctypes.POINTER(_H), ctypes.POINTER(_INT),
                 ctypes.POINTER(_FLT))
_STR = ctypes.c_char_p
_CREATE = [_INT, _INT, _INT, _FLT, _PF, _PI, _PI, _PF]

# argtypes of every function of cpp/include/cuopt_c.h, in its order; each
# returns a cuopt_int_t status
SIGNATURES = {
    "cuOptReadProblem": [_STR, _PH],
    "cuOptCreateProblem": _CREATE + [_STR, _PF, _PF, _PF, _STR, _PH],
    "cuOptCreateRangedProblem": _CREATE + [_PF, _PF, _PF, _PF, _STR, _PH],
    "cuOptDestroyProblem": [_PH],
    "cuOptGetNumConstraints": [_H, _PI],
    "cuOptGetNumVariables": [_H, _PI],
    "cuOptGetNumNonZeros": [_H, _PI],
    "cuOptGetObjectiveSense": [_H, _PI],
    "cuOptGetObjectiveOffset": [_H, _PF],
    "cuOptGetObjectiveCoefficients": [_H, _PF],
    "cuOptGetConstraintMatrix": [_H, _PI, _PI, _PF],
    "cuOptGetConstraintSense": [_H, _STR],
    "cuOptGetConstraintRightHandSide": [_H, _PF],
    "cuOptGetConstraintLowerBounds": [_H, _PF],
    "cuOptGetConstraintUpperBounds": [_H, _PF],
    "cuOptGetVariableLowerBounds": [_H, _PF],
    "cuOptGetVariableUpperBounds": [_H, _PF],
    "cuOptGetVariableTypes": [_H, _STR],
    "cuOptIsMIP": [_H, _PI],
    "cuOptCreateSolverSettings": [_PH],
    "cuOptDestroySolverSettings": [_PH],
    "cuOptSetParameter": [_H, _STR, _STR],
    "cuOptGetParameter": [_H, _STR, _INT, _STR],
    "cuOptSetFloatParameter": [_H, _STR, _FLT],
    "cuOptSetIntegerParameter": [_H, _STR, _INT],
    "cuOptGetFloatParameter": [_H, _STR, _PF],
    "cuOptGetIntegerParameter": [_H, _STR, _PI],
    "cuOptSolve": [_H, _H, _PH],
    "cuOptDestroySolution": [_PH],
    "cuOptGetTerminationStatus": [_H, _PI],
    "cuOptGetObjectiveValue": [_H, _PF],
    "cuOptGetPrimalSolution": [_H, _PF],
    "cuOptGetDualSolution": [_H, _PF],
    "cuOptGetReducedCosts": [_H, _PF],
    "cuOptGetSolveTime": [_H, _PF],
    "cuOptGetMIPGap": [_H, _PF],
    "cuOptGetSolutionBound": [_H, _PF],
    "cuOptGetIntSize": [],
    "cuOptGetFloatSize": [],
}

_TYPES_LOCK = threading.Lock()


def load_library() -> ctypes.CDLL:
    """The port's C ABI library, built on first use, with every entry
    point's types declared once, under a lock (setting them while another
    thread is inside a call corrupts the converters that call reads).
    Loaded into this process, it runs cuopt_torch on this interpreter."""
    from cuopt_torch.kernels.build import BUILDER

    lib = BUILDER.capi_library()
    with _TYPES_LOCK:
        if not getattr(lib, "_cuopt_torch_typed", False):
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = _INT, argtypes
            lib._cuopt_torch_typed = True
    return lib
