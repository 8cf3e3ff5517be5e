"""cuopt_torch's C API against cuopt_tpu's, and the port's build of the C
ABI (cpp/c_api/cuopt_c.c) through ctypes and from a C program.

- `cuopt_torch.c_api` function by function against `cuopt_tpu.c_api` on
  the same problems: status codes, problem getters, parameters, solution
  getters, error strings. Solves use the dual simplex (the same host code
  in both packages), the port's on the CPU (CUOPT_TORCH_DEVICE=cpu).
- The C ABI library, built by cuopt_torch/kernels/build.py, loaded into
  this process through ctypes; its ctypes declarations held against the
  prototypes of cpp/include/cuopt_c.h.
- csrc/c_api_check.c, a C program linked against the library and
  libpython, run as a process.
- No fallback: a library that does not build raises, and without a card
  (and without CUOPT_TORCH_DEVICE=cpu) the C ABI refuses to solve.
"""

import ctypes
import re
import subprocess

import numpy as np
import pytest
import torch

import cuopt_tpu.c_api as tpu_capi
from cuopt_torch import c_api as port_capi
from cuopt_torch import c_api_embed
from cuopt_torch import constants as C
from cuopt_torch.kernels import build
from cuopt_torch.problem.data_model import OptimizationProblem
from cuopt_torch.problem.synthetic import generate_lp
from torch_mip_instances import twelve_binaries
from torch_surface_instances import staircase, write_mps

torch.set_num_threads(1)

HEADER = build.CAPI_HEADER
DEADLINE = 120


@pytest.fixture(autouse=True)
def cpu_entry(monkeypatch):
    monkeypatch.setenv("CUOPT_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def lp_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("capi") / "lp.mps"
    path.write_text(write_mps(staircase(generate_lp), "S200"))
    return str(path)


def _get(api, fn, *args, n_out=1):
    """fn(*args, out...) with `n_out` out lists: (status, [outputs])."""
    outs = [[] for _ in range(n_out)]
    status = getattr(api, fn)(*args, *outs)
    return status, [o[0] if o else None for o in outs]


PROBLEM_GETTERS = [
    "cuOptGetNumConstraints", "cuOptGetNumVariables", "cuOptGetNumNonZeros",
    "cuOptGetObjectiveSense", "cuOptGetObjectiveOffset",
    "cuOptGetObjectiveCoefficients", "cuOptGetConstraintSense",
    "cuOptGetConstraintRightHandSide", "cuOptGetConstraintLowerBounds",
    "cuOptGetConstraintUpperBounds", "cuOptGetVariableLowerBounds",
    "cuOptGetVariableUpperBounds", "cuOptGetVariableTypes", "cuOptIsMIP",
]


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert a == b


def assert_same_problem_handles(port, tpu):
    for fn in PROBLEM_GETTERS:
        sp, (vp,) = _get(port_capi, fn, port)
        st, (vt,) = _get(tpu_capi, fn, tpu)
        assert sp == st == C.CUOPT_SUCCESS, fn
        _same(vp, vt)
    sp, vp = _get(port_capi, "cuOptGetConstraintMatrix", port, n_out=3)
    st, vt = _get(tpu_capi, "cuOptGetConstraintMatrix", tpu, n_out=3)
    assert sp == st == C.CUOPT_SUCCESS
    for a, b in zip(vp, vt):
        _same(a, b)


def _arrays(p):
    """cuOptCreateProblem's arguments of an OptimizationProblem (rows as
    L/G/E with a right-hand side)."""
    lc, uc = p.constraint_lower_bounds, p.constraint_upper_bounds
    sense = np.where(lc == uc, "E", np.where(np.isfinite(uc), "L", "G"))
    rhs = np.where(np.isfinite(uc), uc, lc)
    return (p.n_constraints, p.n_variables,
            C.CUOPT_MAXIMIZE if p.maximize else C.CUOPT_MINIMIZE,
            float(p.objective_offset),
            np.asarray(p.objective_coefficients, np.float64),
            np.asarray(p.offsets, np.int32), np.asarray(p.indices, np.int32),
            np.asarray(p.values, np.float64), sense, rhs,
            np.asarray(p.variable_lower_bounds, np.float64),
            np.asarray(p.variable_upper_bounds, np.float64),
            np.asarray(p.variable_types))


def test_read_problem_getters_equal(lp_file, tmp_path):
    port, tpu = [], []
    assert port_capi.cuOptReadProblem(lp_file, port) == \
        tpu_capi.cuOptReadProblem(lp_file, tpu) == C.CUOPT_SUCCESS
    assert_same_problem_handles(port, tpu)
    bad = tmp_path / "bad.mps"
    bad.write_text("NAME B\nROWS\n N obj\nCOLUMNS\n    x obj 1.2.3\nENDATA\n")
    for path in (str(tmp_path / "missing.mps"), str(bad)):
        assert port_capi.cuOptReadProblem(path, []) == \
            tpu_capi.cuOptReadProblem(path, []) == C.CUOPT_MPS_FILE_ERROR
    assert port_capi.cuOptDestroyProblem(port) == C.CUOPT_SUCCESS
    assert port == []


def test_create_problems_equal():
    p = twelve_binaries(OptimizationProblem)
    args = _arrays(p)
    port, tpu = [], []
    assert port_capi.cuOptCreateProblem(*args, port) == \
        tpu_capi.cuOptCreateProblem(*args, tpu) == C.CUOPT_SUCCESS
    assert_same_problem_handles(port, tpu)
    ranged = (*args[:8], p.constraint_lower_bounds,
              p.constraint_upper_bounds, *args[10:])
    port, tpu = [], []
    assert port_capi.cuOptCreateRangedProblem(*ranged, port) == \
        tpu_capi.cuOptCreateRangedProblem(*ranged, tpu) == C.CUOPT_SUCCESS
    assert_same_problem_handles(port, tpu)
    # a row sense the data model refuses, and bounds out of order
    bad = list(args)
    bad[8] = np.array(["X"] * p.n_constraints)
    assert port_capi.cuOptCreateProblem(*bad, []) == \
        tpu_capi.cuOptCreateProblem(*bad, []) == C.CUOPT_INVALID_ARGUMENT
    bad = list(args)
    bad[10] = np.full(p.n_variables, 2.0)
    assert port_capi.cuOptCreateProblem(*bad, []) == \
        tpu_capi.cuOptCreateProblem(*bad, []) == C.CUOPT_INVALID_ARGUMENT


@pytest.mark.parametrize("call", [
    ("cuOptSetParameter", C.CUOPT_METHOD, "2"),
    ("cuOptSetParameter", C.CUOPT_CROSSOVER, "true"),
    ("cuOptSetParameter", C.CUOPT_CROSSOVER, "maybe"),
    ("cuOptSetParameter", "bogus_parameter", 1),
    ("cuOptSetFloatParameter", C.CUOPT_TIME_LIMIT, 12.5),
    ("cuOptSetIntegerParameter", C.CUOPT_ITERATION_LIMIT, 700),
    ("cuOptSetFloatParameter", "bogus_parameter", 1.0),
    ("cuOptSetParameter", C.CUOPT_SOLUTION_FILE, "x.sol"),
])
def test_parameters_equal(call):
    fn, name, value = call
    port, tpu = [], []
    port_capi.cuOptCreateSolverSettings(port)
    tpu_capi.cuOptCreateSolverSettings(tpu)
    assert getattr(port_capi, fn)(port, name, value) == \
        getattr(tpu_capi, fn)(tpu, name, value)
    for getter in ("cuOptGetParameter", "cuOptGetFloatParameter",
                   "cuOptGetIntegerParameter"):
        sp, (vp,) = _get(port_capi, getter, port, name)
        st, (vt,) = _get(tpu_capi, getter, tpu, name)
        assert sp == st, getter
        assert vp == vt, getter
    assert port_capi.cuOptDestroySolverSettings(port) == C.CUOPT_SUCCESS


SOLUTION_SCALARS = ["cuOptGetTerminationStatus", "cuOptGetObjectiveValue",
                    "cuOptGetMIPGap", "cuOptGetSolutionBound"]
SOLUTION_ARRAYS = ["cuOptGetPrimalSolution", "cuOptGetDualSolution",
                   "cuOptGetReducedCosts"]


@pytest.mark.parametrize("case", ["lp", "mip"])
def test_solve_and_solution_getters_equal(case, lp_file):
    handles = {}
    for name, api in (("port", port_capi), ("tpu", tpu_capi)):
        prob, settings, sol = [], [], []
        if case == "lp":
            assert api.cuOptReadProblem(lp_file, prob) == C.CUOPT_SUCCESS
        else:
            p = twelve_binaries(OptimizationProblem)
            assert api.cuOptCreateProblem(*_arrays(p), prob) == 0
        api.cuOptCreateSolverSettings(settings)
        api.cuOptSetParameter(settings, C.CUOPT_LOG_TO_CONSOLE, "false")
        if case == "lp":
            api.cuOptSetIntegerParameter(settings, C.CUOPT_METHOD,
                                         C.CUOPT_METHOD_DUAL_SIMPLEX)
        assert api.cuOptSolve(prob, settings, sol) == C.CUOPT_SUCCESS
        handles[name] = sol
    for fn in SOLUTION_SCALARS:
        sp, (vp,) = _get(port_capi, fn, handles["port"])
        st, (vt,) = _get(tpu_capi, fn, handles["tpu"])
        assert sp == st, fn
        assert np.isclose(vp, vt, rtol=1e-9, atol=1e-9, equal_nan=True), fn
    status = []
    port_capi.cuOptGetTerminationStatus(handles["port"], status)
    assert status[0] == C.CUOPT_TERIMINATION_STATUS_OPTIMAL
    for fn in SOLUTION_ARRAYS:
        sp, (vp,) = _get(port_capi, fn, handles["port"])
        st, (vt,) = _get(tpu_capi, fn, handles["tpu"])
        assert sp == st, fn
        if sp == C.CUOPT_SUCCESS:
            np.testing.assert_allclose(vp, vt, rtol=1e-9, atol=1e-9)
    sp, (t,) = _get(port_capi, "cuOptGetSolveTime", handles["port"])
    assert sp == C.CUOPT_SUCCESS and t >= 0
    assert port_capi.cuOptDestroySolution(handles["port"]) == 0


@pytest.mark.parametrize("status", [0, 1, 2, 3, 4, 5, 6, 99])
def test_error_strings_equal(status):
    assert port_capi.cuOptGetErrorString(status) == \
        tpu_capi.cuOptGetErrorString(status)
    assert port_capi.cuOptGetErrorStatus(status) == status


def test_sizes():
    assert port_capi.cuOptGetIntSize() == tpu_capi.cuOptGetIntSize() == 4
    assert port_capi.cuOptGetFloatSize() == tpu_capi.cuOptGetFloatSize() == 8


def test_without_a_card_the_solve_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.delenv("CUOPT_TORCH_DEVICE")
    prob, settings = [], []
    port_capi.cuOptCreateProblem(*_arrays(twelve_binaries(
        OptimizationProblem)), prob)
    port_capi.cuOptCreateSolverSettings(settings)
    with pytest.raises((RuntimeError, AssertionError)):
        port_capi.cuOptSolve(prob, settings, [])


# ------------------------------------------------------- the C ABI itself
def _prototypes():
    """{name: [parameter C types]} of cpp/include/cuopt_c.h; every
    function returns cuopt_int_t."""
    text = re.sub(r"/\*.*?\*/", "", HEADER.read_text(), flags=re.S)
    out = {}
    for name, params in re.findall(
            r"cuopt_int_t\s+(cuOpt\w+)\s*\(([^)]*)\)\s*;", text):
        types = []
        for p in params.split(","):
            p = " ".join(p.split())
            if p and p != "void":
                types.append(re.sub(r"\s*\b\w+$", "", p).replace(" *", "*"))
        out[name] = types
    return out


_HANDLES = ("cuOptOptimizationProblem", "cuOptSolverSettings",
            "cuOptSolution")


def _ctype_of(c_type):
    base = c_type.removeprefix("const ")
    if base in ("char*",):
        return ctypes.c_char_p
    if base in _HANDLES:
        return ctypes.c_void_p
    if base.rstrip("*") in _HANDLES:
        return ctypes.POINTER(ctypes.c_void_p)
    scalar = {"cuopt_int_t": ctypes.c_int32,
              "cuopt_float_t": ctypes.c_double}[base.rstrip("*")]
    return ctypes.POINTER(scalar) if base.endswith("*") else scalar


def test_every_prototype_is_declared():
    protos = _prototypes()
    assert len(protos) == 39
    assert list(protos) == list(c_api_embed.SIGNATURES)


@pytest.mark.parametrize("name", list(c_api_embed.SIGNATURES))
def test_argtypes_match_the_prototype(name):
    want = [_ctype_of(t) for t in _prototypes()[name]]
    assert c_api_embed.SIGNATURES[name] == want


def _int(v=0):
    return ctypes.c_int32(v)


def test_library_in_process(lp_file):
    """The library through ctypes, in this process: the same objective,
    arrays and parameters as the Python API."""
    lib = c_api_embed.load_library()
    assert lib.cuOptSolve.restype is ctypes.c_int32
    prob, settings, sol = (ctypes.c_void_p() for _ in range(3))
    assert lib.cuOptReadProblem(lp_file.encode(), ctypes.byref(prob)) == 0
    n, m = _int(), _int()
    lib.cuOptGetNumConstraints(prob, ctypes.byref(n))
    lib.cuOptGetNumVariables(prob, ctypes.byref(m))
    assert (n.value, m.value) == (200, 200)
    lb = np.zeros(m.value)
    assert lib.cuOptGetVariableLowerBounds(
        prob, lb.ctypes.data_as(ctypes.POINTER(ctypes.c_double))) == 0
    want = []
    port_capi.cuOptReadProblem(lp_file, want)
    np.testing.assert_array_equal(lb, want[0].prob.variable_lower_bounds)
    assert lib.cuOptCreateSolverSettings(ctypes.byref(settings)) == 0
    assert lib.cuOptSetParameter(settings, b"method", b"2") == 0
    assert lib.cuOptSetParameter(settings, b"log_to_console", b"0") == 0
    assert lib.cuOptSetParameter(settings, b"bogus", b"1") == \
        C.CUOPT_INVALID_ARGUMENT
    buf = ctypes.create_string_buffer(32)
    assert lib.cuOptGetParameter(settings, b"method", 32, buf) == 0
    assert buf.value == b"2"
    assert lib.cuOptSolve(prob, settings, ctypes.byref(sol)) == 0
    status, obj = _int(), ctypes.c_double()
    lib.cuOptGetTerminationStatus(sol, ctypes.byref(status))
    lib.cuOptGetObjectiveValue(sol, ctypes.byref(obj))
    s = []
    port_capi.cuOptCreateSolverSettings(s)
    port_capi.cuOptSetParameter(s, "method", "2")
    port_capi.cuOptSetParameter(s, "log_to_console", "0")
    ref = []
    port_capi.cuOptSolve(want, s, ref)
    assert status.value == C.CUOPT_TERIMINATION_STATUS_OPTIMAL
    assert obj.value == ref[0].solution.get_primal_objective()
    assert lib.cuOptDestroySolution(ctypes.byref(sol)) == 0
    assert lib.cuOptDestroySolverSettings(ctypes.byref(settings)) == 0
    assert lib.cuOptDestroyProblem(ctypes.byref(prob)) == 0
    assert prob.value is None


def _create_two_row_lp(lib):
    """c_api_check.c's LP through cuOptCreateProblem: (status, handle)."""
    P = ctypes.POINTER
    f64 = np.array
    c = f64([-0.2, -0.1])
    offs = np.array([0, 2, 4], np.int32)
    idx = np.array([0, 1, 0, 1], np.int32)
    vals = f64([3.0, 4.0, 2.7, 10.1])
    rhs, lb, ub = f64([5.4, 4.9]), f64([0.0, 0.0]), f64([np.inf, np.inf])
    prob = ctypes.c_void_p()

    def d(a):
        return a.ctypes.data_as(P(ctypes.c_double))

    def i(a):
        return a.ctypes.data_as(P(ctypes.c_int32))

    status = lib.cuOptCreateProblem(2, 2, C.CUOPT_MINIMIZE, 0.0, d(c),
                                    i(offs), i(idx), d(vals), b"LL", d(rhs),
                                    d(lb), d(ub), b"CC", ctypes.byref(prob))
    return status, prob


def test_create_problem_format_repair(tmp_path):
    """cpp/c_api/cuopt_c.c passes cuOptCreateProblem's 14 arguments with
    a 13-conversion format, so the bridge gets no nnz and the call fails
    (CUOPT_RUNTIME_ERROR); the port's copy repairs the format
    (kernels/build.py CAPI_PATCHES). Built both ways here."""
    source = tmp_path / "cuopt_c_unrepaired.c"
    source.write_bytes(build.capi_source(build.CAPI_PATCHES[:1]))
    lib_path = tmp_path / "libunrepaired.so"
    subprocess.run([build.gcc(), *build.CAPI_FLAGS, "-o", str(lib_path),
                    str(source)], check=True, capture_output=True,
                   timeout=DEADLINE)
    unrepaired = ctypes.CDLL(str(lib_path))
    for name, argtypes in c_api_embed.SIGNATURES.items():
        fn = getattr(unrepaired, name)
        fn.restype, fn.argtypes = ctypes.c_int32, argtypes
    assert _create_two_row_lp(unrepaired)[0] == C.CUOPT_RUNTIME_ERROR
    status, prob = _create_two_row_lp(c_api_embed.load_library())
    assert status == C.CUOPT_SUCCESS
    c_api_embed.load_library().cuOptDestroyProblem(ctypes.byref(prob))


def _run_check(env, *args):
    exe = build.BUILDER.c_api_check()
    return subprocess.run([str(exe), *args], env=env, capture_output=True,
                          text=True, timeout=DEADLINE)


def test_c_program():
    """c_api_check (a C program linked against the library and libpython)
    solves its LP on the CPU by the dual simplex and by PDLP."""
    env = build.embed_env()
    for method, tol in (("2", 1e-12), ("1", 1e-4)):
        r = _run_check(env, method)
        assert r.returncode == 0, (r.stdout, r.stderr[-2000:])
        m = re.fullmatch(r"status (\d+) objective (\S+) x0 (\S+) x1 (\S+)",
                         r.stdout.strip())
        assert m, r.stdout
        assert int(m.group(1)) == C.CUOPT_TERIMINATION_STATUS_OPTIMAL
        assert abs(float(m.group(2)) + 0.36) <= tol * 0.36
        assert abs(float(m.group(3)) - 1.8) <= 1e-3


def test_c_program_without_a_card_refuses(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.delenv("CUOPT_TORCH_DEVICE")
    r = _run_check(build.embed_env(), "2")
    assert r.returncode == 1
    assert "cuOptSolve" in r.stdout and \
        f"returned {C.CUOPT_RUNTIME_ERROR}" in r.stdout


def test_failed_builds_raise(monkeypatch, tmp_path):
    """No fallback: a library that does not build raises, with the
    compiler's output."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "gcc", lambda: "false")  # exits 1
    monkeypatch.setattr(build, "gxx", lambda: "false")
    builder = build.Builder()
    with pytest.raises(RuntimeError, match="failed on"):
        builder.capi_library()
    with pytest.raises(RuntimeError, match="failed on"):
        builder.mps_library()
    assert not list((tmp_path / "_build").glob("*.so"))


def test_embed_ldflags_are_python3_configs():
    """The C program links what `python3-config --ldflags --embed` names,
    computed from sysconfig."""
    import shutil
    import sysconfig

    config = shutil.which(f"python{sysconfig.get_config_var('VERSION')}"
                          "-config")
    flags = set(build.embed_ldflags())
    assert f"-lpython{sysconfig.get_config_var('LDVERSION')}" in flags
    if config is not None:
        out = subprocess.run([config, "--ldflags", "--embed"],
                             capture_output=True, text=True, timeout=60)
        assert set(out.stdout.split()) <= flags
