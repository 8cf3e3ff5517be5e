"""ctypes binding for the native C++ MPS parser (cpp/mps_parser/).

Counterpart of cuopt_tpu/io/native_mps.py. Role parity with the
reference's separately-packaged native parser (cpp/libmps_parser/, wheel
`cuopt_mps_parser`): the heavy tokenization and CSR assembly run in C++;
Python only wraps the flat arrays into an OptimizationProblem. The port
builds the shared source into a library of its own
(kernels/build.py `Builder.mps_library()`) at first use; a missing g++ or
a failed build raises. The pure-Python parser (io/mps_parser.py) runs
only when the caller asks for it.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from cuopt_torch.kernels.build import BUILDER
from cuopt_torch.problem.data_model import OptimizationProblem
from cuopt_torch.utils.errors import MpsParseError

_P = ctypes.POINTER
_H, _I64, _DBL = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double

# (restype, argtypes) of each entry point, in the order of the extern "C"
# block at the bottom of cpp/mps_parser/mps_parser.cpp
SIGNATURES = {
    "mps_parse_string": (_H, [ctypes.c_char_p, ctypes.c_int]),
    "mps_parse": (_H, [ctypes.c_char_p, ctypes.c_int]),
    "mps_error": (ctypes.c_char_p, [_H]),
    "mps_num_rows": (_I64, [_H]),
    "mps_num_cols": (_I64, [_H]),
    "mps_num_nnz": (_I64, [_H]),
    "mps_maximize": (ctypes.c_int, [_H]),
    "mps_objective_offset": (_DBL, [_H]),
    "mps_get_csr": (None, [_H, _P(_I64), _P(_I64), _P(_DBL)]),
    "mps_get_objective": (None, [_H, _P(_DBL)]),
    "mps_get_constraint_bounds": (None, [_H, _P(_DBL), _P(_DBL), _P(_DBL)]),
    "mps_get_variable_bounds": (None, [_H, _P(_DBL), _P(_DBL)]),
    "mps_get_types": (None, [_H, _P(ctypes.c_char), _P(ctypes.c_char)]),
    "mps_problem_name": (ctypes.c_char_p, [_H]),
    "mps_objective_name": (ctypes.c_char_p, [_H]),
    "mps_var_name": (ctypes.c_char_p, [_H, _I64]),
    "mps_row_name": (ctypes.c_char_p, [_H, _I64]),
    "mps_free": (None, [_H]),
}

_TYPES_LOCK = threading.Lock()


def load_library() -> ctypes.CDLL:
    """The parser library, built on first use, with every entry point's
    types declared once (setting them while another thread is inside a
    call corrupts the converters that call reads)."""
    lib = BUILDER.mps_library()
    with _TYPES_LOCK:
        if not getattr(lib, "_cuopt_torch_typed", False):
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            lib._cuopt_torch_typed = True
    return lib


def available() -> bool:
    """Whether the parser library builds and loads (a failed build
    raises)."""
    return load_library() is not None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _extract(lib, h) -> OptimizationProblem:
    err = lib.mps_error(h)
    if err is not None:
        msg = err.decode("utf-8", "replace")
        lib.mps_free(h)
        raise MpsParseError(msg)
    n = lib.mps_num_rows(h)
    m = lib.mps_num_cols(h)
    nnz = lib.mps_num_nnz(h)
    offsets = np.zeros(n + 1, np.int64)
    indices = np.zeros(max(nnz, 1), np.int64)
    values = np.zeros(max(nnz, 1), np.float64)
    lib.mps_get_csr(h, _ptr(offsets, ctypes.c_int64),
                    _ptr(indices, ctypes.c_int64),
                    _ptr(values, ctypes.c_double))
    c = np.zeros(max(m, 1), np.float64)
    lib.mps_get_objective(h, _ptr(c, ctypes.c_double))
    lc = np.zeros(max(n, 1), np.float64)
    uc = np.zeros(max(n, 1), np.float64)
    rhs = np.zeros(max(n, 1), np.float64)
    lib.mps_get_constraint_bounds(h, _ptr(lc, ctypes.c_double),
                                  _ptr(uc, ctypes.c_double),
                                  _ptr(rhs, ctypes.c_double))
    lv = np.zeros(max(m, 1), np.float64)
    uv = np.zeros(max(m, 1), np.float64)
    lib.mps_get_variable_bounds(h, _ptr(lv, ctypes.c_double),
                                _ptr(uv, ctypes.c_double))
    row_t = np.zeros(max(n, 1), "S1")
    var_t = np.zeros(max(m, 1), "S1")
    lib.mps_get_types(h, _ptr(row_t, ctypes.c_char),
                      _ptr(var_t, ctypes.c_char))
    prob = OptimizationProblem(
        offsets=offsets,
        indices=indices[:nnz],
        values=values[:nnz],
        objective_coefficients=c[:m],
        objective_offset=lib.mps_objective_offset(h),
        maximize=bool(lib.mps_maximize(h)),
        constraint_lower_bounds=lc[:n],
        constraint_upper_bounds=uc[:n],
        row_types=row_t[:n].astype("U1"),
        rhs=rhs[:n],
        variable_lower_bounds=lv[:m],
        variable_upper_bounds=uv[:m],
        variable_types=var_t[:m].astype("U1"),
        problem_name=lib.mps_problem_name(h).decode("utf-8", "replace"),
        objective_name=lib.mps_objective_name(h).decode("utf-8", "replace"),
        variable_names=[
            lib.mps_var_name(h, j).decode("utf-8", "replace")
            for j in range(m)
        ],
        row_names=[
            lib.mps_row_name(h, i).decode("utf-8", "replace")
            for i in range(n)
        ],
    )
    lib.mps_free(h)
    return prob


def parse_mps_native(path: str,
                     fixed_format: bool = False) -> OptimizationProblem:
    """Parse an MPS file with the native C++ parser."""
    lib = load_library()
    h = lib.mps_parse(str(path).encode(), 1 if fixed_format else 0)
    prob = _extract(lib, h)
    prob.validate()
    return prob


def parse_mps_string_native(text: str,
                            fixed_format: bool = False) -> OptimizationProblem:
    """Parse MPS text with the native C++ parser."""
    lib = load_library()
    h = lib.mps_parse_string(text.encode(), 1 if fixed_format else 0)
    prob = _extract(lib, h)
    prob.validate()
    return prob
