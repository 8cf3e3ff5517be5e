"""cuopt_torch's dual simplex bindings and crossover against cuopt_tpu's.

Both packages build cpp/dual_simplex/simplex.cpp into the same machine
code, each into a library of its own, and pass it the same arrays: so
every solve here must agree bit for bit (status, pivots, x, y, reduced
costs, objective). The ctypes declarations are held against the C
prototypes. The port adds -fno-gnu-unique to cuopt_tpu's g++ flags;
without it the two libraries would share one set of options in a process
that loads both (test_options_round_trip_and_stay_the_ports_own).
"""

import ctypes
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import cuopt_torch.dual_simplex.bindings as TB  # noqa: E402
import cuopt_torch.kernels.build as build  # noqa: E402
import cuopt_tpu.dual_simplex.bindings as JB  # noqa: E402
from cuopt_torch import constants as C  # noqa: E402
from cuopt_torch.dual_simplex import is_available  # noqa: E402
from cuopt_torch.dual_simplex.crossover import crossover as t_crossover  # noqa: E402
from cuopt_torch.lp.settings import PDLPSolverSettings as TSettings  # noqa: E402
from cuopt_torch.lp.solve import solve_lp as t_solve_lp  # noqa: E402
from cuopt_torch.problem.data_model import OptimizationProblem as TProblem  # noqa: E402
from cuopt_torch.problem.synthetic import generate_lp as t_generate  # noqa: E402
from cuopt_torch.utils.timer import Timer as TTimer  # noqa: E402
from cuopt_tpu.dual_simplex.crossover import crossover as j_crossover  # noqa: E402
from cuopt_tpu.lp.pdlp import PdlpSolver as JPdlpSolver  # noqa: E402
from cuopt_tpu.lp.settings import PDLPSolverSettings as JSettings  # noqa: E402
from cuopt_tpu.lp.solve import solve_lp as j_solve_lp  # noqa: E402
from cuopt_tpu.problem.data_model import OptimizationProblem as JProblem  # noqa: E402
from cuopt_tpu.problem.synthetic import generate_lp as j_generate  # noqa: E402
from cuopt_tpu.utils.timer import Timer as JTimer  # noqa: E402
from test_torch_kernel_abi import _prototypes  # noqa: E402

torch.set_num_threads(1)

SIMPLEX_CPP = build.SIMPLEX_DIR / "simplex.cpp"
_RESULT_ARRAYS = ("primal_solution", "dual_solution", "reduced_cost")


# ------------------------------------------------------------ instances
# each builds the same LP from either package's classes: (problem class,
# generate_lp) -> problem
def _staircase(P, gen):
    return gen(800, 1000, 5, seed=3, band=200)


def _staircase_max(P, gen):
    return dataclasses.replace(_staircase(P, gen), maximize=True)


def _singleton_rows_infeasible(P, gen):
    # x0 >= 5 and x0 <= 3 through two singleton rows
    return P.from_dense(
        np.array([[1.0], [1.0]]), c=np.array([1.0]),
        constraint_lower=np.array([5.0, -np.inf]),
        constraint_upper=np.array([np.inf, 3.0]),
        variable_lower=np.array([-10.0]), variable_upper=np.array([10.0]))


def _badly_scaled(P, gen):
    return P.from_dense(
        np.array([[1e6, 1e-6], [1e-6, 1e6]]), c=np.array([-1e-6, -1e6]),
        constraint_lower=np.array([-np.inf, -np.inf]),
        constraint_upper=np.array([1e6, 1e6]),
        variable_lower=np.zeros(2), variable_upper=np.full(2, 1e7))


def _degenerate_assignment(P, gen, n=8):
    # supply rows sum_j x_ij = 1, demand rows sum_i x_ij = 1, integer costs
    A = np.zeros((2 * n, n * n))
    for i in range(n):
        A[i, i * n:(i + 1) * n] = 1.0
        A[n + i, i::n] = 1.0
    cost = np.random.default_rng(3).integers(1, 10, n * n).astype(float)
    return P.from_dense(A, c=cost, constraint_lower=np.ones(2 * n),
                        constraint_upper=np.ones(2 * n),
                        variable_lower=np.zeros(n * n),
                        variable_upper=np.ones(n * n))


def _free_variables(P, gen, n=40, m=25):
    # all columns free, c in the row space of A: bounded and maximally
    # degenerate (tests/test_dual_simplex.py's synthetic-free LP)
    rng = np.random.default_rng(3)
    A = rng.standard_normal((m, n)) * (rng.random((m, n)) < 0.3)
    b = A @ rng.standard_normal(n)
    return P.from_dense(A, c=A.T @ rng.standard_normal(m),
                        constraint_lower=b, constraint_upper=b,
                        variable_lower=np.full(n, -np.inf),
                        variable_upper=np.full(n, np.inf))


def _unbounded(P, gen, n=128):
    # a staircase plus a variable in no row, with cost -10 and no upper
    # bound (ROADMAP Queue 3: the unbounded LP that PDLP's detection
    # certifies correctly)
    p = gen(n, n, 4, seed=3, band=32)
    return dataclasses.replace(
        p, objective_coefficients=np.append(p.objective_coefficients, -10.0),
        variable_lower_bounds=np.append(p.variable_lower_bounds, 0.0),
        variable_upper_bounds=np.append(p.variable_upper_bounds, np.inf),
        variable_types=np.append(p.variable_types, "C"), variable_names=[])


INSTANCES = {
    "staircase-800x1000": (_staircase, C.CUOPT_TERIMINATION_STATUS_OPTIMAL),
    "staircase-800x1000-max": (_staircase_max,
                               C.CUOPT_TERIMINATION_STATUS_OPTIMAL),
    "singleton-rows-infeasible": (_singleton_rows_infeasible,
                                  C.CUOPT_TERIMINATION_STATUS_INFEASIBLE),
    "badly-scaled-2x2": (_badly_scaled, C.CUOPT_TERIMINATION_STATUS_OPTIMAL),
    "degenerate-assignment-8x8": (_degenerate_assignment,
                                  C.CUOPT_TERIMINATION_STATUS_OPTIMAL),
    "free-variables-40x25": (_free_variables,
                             C.CUOPT_TERIMINATION_STATUS_OPTIMAL),
    "unbounded-free-column": (_unbounded,
                              C.CUOPT_TERIMINATION_STATUS_UNBOUNDED),
}


def _pair(name):
    make = INSTANCES[name][0]
    return make(TProblem, t_generate), make(JProblem, j_generate)


def _assert_same_bits(t_raw, j_raw):
    assert t_raw["status"] == j_raw["status"]
    assert t_raw["iterations"] == j_raw["iterations"]
    for k in _RESULT_ARRAYS:
        assert np.array_equal(t_raw[k], j_raw[k]), k
    assert np.array_equal(t_raw["primal_objective"], j_raw["primal_objective"])


# ------------------------------------------------------------------ ABI
_POINTEE = {"int64_t": np.int64, "double": np.float64, "int8_t": np.int8,
            "int": np.int32}
_SCALAR = {"int": ctypes.c_int, "double": ctypes.c_double}


def _matches(declared, c_type) -> bool:
    if not c_type.endswith("*"):
        return declared is _SCALAR[c_type]
    pointee = c_type.removeprefix("const ").rstrip("*")
    if declared is ctypes.c_void_p:  # nullable, passed as an address
        return True
    if hasattr(declared, "_dtype_"):  # np.ctypeslib.ndpointer
        return declared._dtype_ == np.dtype(_POINTEE[pointee])
    return declared._type_ is _SCALAR[pointee]  # ctypes.POINTER


def test_every_entry_point_is_declared():
    # all but ds_solve, which is ds_solve_adv without its warm-start
    # arguments
    assert set(_prototypes(SIMPLEX_CPP)) - {"ds_solve"} == set(TB.SIGNATURES)


@pytest.mark.parametrize("name", sorted(TB.SIGNATURES))
def test_argtypes_match_the_prototype(name):
    ret, params = _prototypes(SIMPLEX_CPP)[name]
    restype, argtypes = TB.SIGNATURES[name]
    assert (restype is None) == (ret == "void")
    if restype is not None:
        assert restype is _SCALAR[ret]
    assert len(argtypes) == len(params)
    for i, (declared, c_type) in enumerate(zip(argtypes, params)):
        assert _matches(declared, c_type), (name, i, c_type, declared)


def test_library_is_the_ports_own():
    lib = build.simplex_target()
    assert lib.parent == build.BUILD_DIR and lib.name.startswith("libsimplex-")
    assert is_available()
    assert lib.exists()
    assert Path(JB._LIB_PATH).resolve() != lib.resolve()


def test_concurrent_calls_from_threads():
    """Many threads solving at once, as strong branching's pool does, all
    get the single-thread answer: the entry points' types are declared
    once, never while another thread is inside a call. (Declared at
    every call, with the interpreter switching threads every microsecond
    as below, this crashed the process within 200 calls.)"""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    prob = t_generate(48, 48, 4, seed=9)
    want = TB.solve_lp_simplex(prob, TSettings(), TTimer(60))

    def solve(_):
        return TB.solve_lp_simplex(prob, TSettings(), TTimer(60))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(8) as pool:
            raws = list(pool.map(solve, range(200)))
    finally:
        sys.setswitchinterval(interval)
    for raw in raws:
        assert raw["status"] == want["status"]
        assert np.array_equal(raw["primal_solution"], want["primal_solution"])


# -------------------------------------------------------- bit for bit
@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_solve_matches_cuopt_tpu_bit_for_bit(name):
    t_prob, j_prob = _pair(name)
    t_raw = TB.solve_lp_simplex(t_prob, TSettings(), TTimer(60))
    j_raw = JB.solve_lp_simplex(j_prob, JSettings(), JTimer(60))
    assert t_raw["status"] == INSTANCES[name][1]
    _assert_same_bits(t_raw, j_raw)


def test_warm_basis_resolve_matches():
    """Re-solve from the optimal basis after a bound change (the B&B node
    path): the same bits in both packages, in far fewer pivots."""
    out = {}
    for key, bindings, S, T, gen in (
            ("t", TB, TSettings, TTimer, t_generate),
            ("j", JB, JSettings, JTimer, j_generate)):
        prob = gen(800, 1000, 5, seed=3, band=200)
        cold = bindings.solve_lp_simplex(prob, S(), T(60), want_vstat=True)
        ub = prob.variable_upper_bounds.copy()
        j = int(np.argmax(cold["primal_solution"]))
        ub[j] = max(prob.variable_lower_bounds[j],
                    cold["primal_solution"][j] * 0.5)
        warm = bindings.solve_lp_simplex(
            dataclasses.replace(prob, variable_upper_bounds=ub), S(), T(60),
            vstat=cold["vstat"], want_vstat=True)
        out[key] = (cold, warm)
    (t_cold, t_warm), (j_cold, j_warm) = out["t"], out["j"]
    _assert_same_bits(t_cold, j_cold)
    _assert_same_bits(t_warm, j_warm)
    assert np.array_equal(t_warm["vstat"], j_warm["vstat"])
    assert t_warm["status"] == C.CUOPT_TERIMINATION_STATUS_OPTIMAL
    assert t_warm["iterations"] <= max(10, t_cold["iterations"] // 2)


def test_preset_halt_stops_both():
    t_prob, j_prob = _pair("staircase-800x1000")
    t_halt, j_halt = ctypes.c_int(1), ctypes.c_int(1)
    t_raw = TB.solve_lp_simplex(t_prob, TSettings(), TTimer(60),
                                halt=ctypes.pointer(t_halt))
    j_raw = JB.solve_lp_simplex(j_prob, JSettings(), JTimer(60),
                                halt=ctypes.byref(j_halt))
    assert t_raw["status"] == j_raw["status"] == \
        C.CUOPT_TERIMINATION_STATUS_CONCURRENT_LIMIT
    assert t_raw["iterations"] == j_raw["iterations"] == 0


def test_options_round_trip_and_stay_the_ports_own():
    t_base, j_base = TB.get_simplex_options(), JB.get_simplex_options()
    try:
        TB.set_simplex_options(refactor_frequency=50,
                               primal_feasibility_tolerance=1e-8)
        got = TB.get_simplex_options()
        assert got["refactor_frequency"] == 50
        assert got["primal_feasibility_tolerance"] == 1e-8
        assert got["pivot_tolerance"] == t_base["pivot_tolerance"]
        assert JB.get_simplex_options() == j_base  # another library
        raw = TB.solve_lp_simplex(_staircase(TProblem, t_generate),
                                  TSettings(), TTimer(60))
        assert raw["status"] == C.CUOPT_TERIMINATION_STATUS_OPTIMAL
        assert not TB.last_used_big_bounds()
    finally:
        TB.set_simplex_options(**t_base)
    assert TB.get_simplex_options() == t_base


# ------------------------------------------------------------ crossover
def _pdlp_settings(S, **kw):
    s = S()
    s.method = C.CUOPT_METHOD_PDLP
    s.log_to_console = False
    for k, v in kw.items():
        setattr(s, k, v)
    return s


@pytest.fixture(scope="module")
def pdlp_point():
    """cuopt_tpu's PDLP result on generate_lp(1500, 1500, 6, seed=5,
    band=160), and the cold simplex's pivots on the same LP."""
    prob = j_generate(1500, 1500, 6, seed=5, band=160)
    raw = JPdlpSolver(prob, _pdlp_settings(JSettings)).run(JTimer(120))
    assert raw["status"] == C.CUOPT_TERIMINATION_STATUS_OPTIMAL
    cold = JB.solve_lp_simplex(prob, JSettings(), JTimer(120))
    return raw, cold


def test_crossover_of_one_pdlp_point_matches(pdlp_point):
    pdlp_raw, cold = pdlp_point
    t_raw = t_crossover(t_generate(1500, 1500, 6, seed=5, band=160),
                        dict(pdlp_raw), _pdlp_settings(TSettings),
                        TTimer(120))
    j_raw = j_crossover(j_generate(1500, 1500, 6, seed=5, band=160),
                        dict(pdlp_raw), _pdlp_settings(JSettings),
                        JTimer(120))
    assert t_raw["solved_by"] == j_raw["solved_by"] == "pdlp+crossover"
    assert t_raw["crossover_iterations"] == j_raw["crossover_iterations"]
    for k in _RESULT_ARRAYS:
        assert np.array_equal(t_raw[k], j_raw[k]), k
    assert t_raw["primal_objective"] == j_raw["primal_objective"]
    # warm: fewer pivots than a cold solve, to the cold solve's vertex
    assert t_raw["crossover_iterations"] < cold["iterations"]
    assert abs(t_raw["primal_objective"] - cold["primal_objective"]) <= \
        1e-9 * abs(cold["primal_objective"])
    # the vertex result keeps the PDLP run's steps and attempts
    assert t_raw["iterations"] == pdlp_raw["iterations"]
    assert t_raw["attempts"] == pdlp_raw["attempts"]


def test_crossover_short_of_optimal_keeps_the_pdlp_point(pdlp_point):
    pdlp_raw, _ = pdlp_point
    got = t_crossover(t_generate(1500, 1500, 6, seed=5, band=160),
                      dict(pdlp_raw),
                      _pdlp_settings(TSettings, iteration_limit=1),
                      TTimer(120))
    assert "solved_by" not in got and "crossover_iterations" not in got
    for k in _RESULT_ARRAYS:
        assert got[k] is pdlp_raw[k]


def test_crossover_end_to_end_matches():
    sols = [solve(gen(384, 384, 5, seed=11, band=64),
                  _pdlp_settings(S, crossover=True), **kw)
            for S, solve, gen, kw in (
                (TSettings, t_solve_lp, t_generate, dict(device="cpu")),
                (JSettings, j_solve_lp, j_generate, {}))]
    t_sol, j_sol = sols
    for sol in sols:
        assert sol.get_termination_reason() == "Optimal"
        info = sol.get_additional_termination_information()
        assert info["solved_by"] == "pdlp+crossover"
    a, b = t_sol.get_primal_objective(), j_sol.get_primal_objective()
    assert abs(a - b) <= 1e-9 * abs(b), (a, b)


def test_crossover_raises_when_the_library_fails(monkeypatch, tmp_path):
    """cuopt_tpu keeps the PDLP point in silence when its library is
    missing (crossover.py:32-34); the port raises, with g++'s output."""
    src = tmp_path / "src"
    src.mkdir()
    for f in build.SIMPLEX_SOURCES:
        (src / f).write_text((build.SIMPLEX_DIR / f).read_text())
    (src / "simplex.cpp").write_text("#error a broken source\n")
    monkeypatch.setattr(build, "SIMPLEX_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(TB, "BUILDER", build.Builder())
    prob = t_generate(64, 64, 4, seed=3)
    pdlp_raw = {"primal_solution": np.zeros(64), "dual_solution": np.zeros(64),
                "iterations": 0, "primal_objective": 0.0}
    with pytest.raises(RuntimeError, match="a broken source"):
        t_crossover(prob, pdlp_raw, _pdlp_settings(TSettings), TTimer(60))
