"""cuopt_torch's concurrent LP race and method dispatch against cuopt_tpu's.

The race runs the native dual simplex on a thread beside PDLP. Which leg
wins depends on the clock, so each test fixes the winner: a small LP that
the simplex solves long before PDLP, or a stub simplex that blocks until
it is halted, so that PDLP wins. cuopt_tpu's PDLP leg first waits up to
3 s for the simplex (its grace poll, min(3 s, 0.2 x the time limit));
the port starts both legs at once.
"""

import ctypes
import logging
import math
import threading
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import cuopt_torch.dual_simplex.concurrent as TC  # noqa: E402
import cuopt_tpu.dual_simplex.bindings as JB  # noqa: E402
import cuopt_tpu.dual_simplex.concurrent as JC  # noqa: E402
import cuopt_tpu.lp.pdlp as JP  # noqa: E402
from cuopt_torch import constants as C  # noqa: E402
from cuopt_torch.dual_simplex.bindings import solve_lp_simplex  # noqa: E402
from cuopt_torch.lp.pdlp import PdlpSolver  # noqa: E402
from cuopt_torch.lp.settings import PDLPSolverSettings as TSettings  # noqa: E402
from cuopt_torch.lp.solve import solve_lp as t_solve_lp  # noqa: E402
from cuopt_torch.problem.synthetic import generate_lp as t_generate  # noqa: E402
from cuopt_torch.utils.logger import get_logger  # noqa: E402
from cuopt_torch.utils.timer import Timer as TTimer  # noqa: E402
from cuopt_tpu.lp.settings import PDLPSolverSettings as JSettings  # noqa: E402
from cuopt_tpu.lp.solve import solve_lp as j_solve_lp  # noqa: E402
from cuopt_tpu.problem.synthetic import generate_lp as j_generate  # noqa: E402
from cuopt_tpu.utils.timer import Timer as JTimer  # noqa: E402

torch.set_num_threads(1)

_ARRAYS = ("primal_solution", "dual_solution", "reduced_cost")


def _settings(S, tol=1e-4, **kw):
    s = S()
    s.log_to_console = False
    s.iteration_limit = 20000
    s.time_limit = 5.0  # cuopt_tpu's grace: min(3 s, 0.2 x 5 s) = 1 s
    s.set_optimality_tolerance(tol)
    for k, v in kw.items():
        setattr(s, k, v)
    return s


def _halt_value(halt):
    # the port passes ctypes.pointer(c_int), cuopt_tpu ctypes.byref(c_int)
    return halt.contents.value if hasattr(halt, "contents") \
        else halt._obj.value


def _blocked_simplex(seen):
    """A simplex leg that blocks until the race halts it."""
    def stub(prob, settings, timer, halt=None, **kw):
        seen["thread"] = threading.current_thread()
        while not _halt_value(halt):
            time.sleep(0.001)
        seen["saw_halt"] = True
        return {"status": C.CUOPT_TERIMINATION_STATUS_CONCURRENT_LIMIT,
                "iterations": 0}
    return stub


def _simplex_threads():
    return [t for t in threading.enumerate() if t.name == TC.SIMPLEX_THREAD]


def test_dual_simplex_method_matches_bit_for_bit():
    sols = [solve(gen(800, 1000, 5, seed=3, band=200),
                  _settings(S, method=C.CUOPT_METHOD_DUAL_SIMPLEX), **kw)
            for S, solve, gen, kw in (
                (TSettings, t_solve_lp, t_generate, dict(device="cpu")),
                (JSettings, j_solve_lp, j_generate, {}))]
    t_sol, j_sol = sols
    assert t_sol.get_termination_reason() == j_sol.get_termination_reason() \
        == "Optimal"
    for get in ("get_primal_solution", "get_dual_solution",
                "get_reduced_costs"):
        assert np.array_equal(getattr(t_sol, get)(), getattr(j_sol, get)())
    assert t_sol.get_primal_objective() == j_sol.get_primal_objective()
    assert t_sol.get_nb_iterations() == j_sol.get_nb_iterations()


def test_simplex_wins_inside_the_grace():
    sols = [solve(gen(300, 300, 5, seed=11, band=64), _settings(S), **kw)
            for S, solve, gen, kw in (
                (TSettings, t_solve_lp, t_generate, dict(device="cpu")),
                (JSettings, j_solve_lp, j_generate, {}))]
    infos = [s.get_additional_termination_information() for s in sols]
    assert [i["solved_by"] for i in infos] == ["dual_simplex"] * 2
    assert sols[0].get_primal_objective() == sols[1].get_primal_objective()
    race = infos[0]["race"]
    # no grace: the PDLP leg ran beside the simplex and was stopped
    assert race["grace_s"] == 0
    assert race["simplex_status"] == C.CUOPT_TERIMINATION_STATUS_OPTIMAL
    assert "compile_s" not in infos[0]  # the simplex's answer came back
    assert not _simplex_threads()


def test_pdlp_wins_against_a_blocked_simplex(monkeypatch):
    """The race's PDLP leg is PdlpSolver.run: the same bits as a run
    alone on the CPU, and cuopt_tpu's race under the same stub within the
    end-to-end tolerance of tests/test_torch_pdlp.py (1e-6 at 1e-8)."""
    seen, j_seen = {}, {}
    monkeypatch.setattr(TC, "solve_lp_simplex", _blocked_simplex(seen))
    monkeypatch.setattr(JB, "solve_lp_simplex", _blocked_simplex(j_seen))
    prob = t_generate(384, 384, 5, seed=11, band=64)
    s = _settings(TSettings, 1e-8)
    # an unlimited timer, so that only the halt ends the simplex
    raw = TC.run_concurrent(prob, s, TTimer(), "cpu")
    alone = PdlpSolver(prob, s, "cpu").run(TTimer())
    assert raw["status"] == alone["status"] == \
        C.CUOPT_TERIMINATION_STATUS_OPTIMAL
    assert raw["solved_by"] == "pdlp"
    assert raw["iterations"] == alone["iterations"]
    for k in _ARRAYS:
        assert np.array_equal(raw[k], alone[k]), k
    assert raw["primal_objective"] == alone["primal_objective"]
    assert seen["saw_halt"] and not seen["thread"].is_alive()
    race = raw["race"]
    # the PDLP leg started without waiting for the blocked simplex (the
    # solve itself takes longer than this bound on the CPU)
    assert race["grace_s"] == 0 and race["grace_waited_s"] < 0.5
    assert raw["solve_time"] > race["grace_waited_s"]
    assert race["simplex_status"] == \
        C.CUOPT_TERIMINATION_STATUS_CONCURRENT_LIMIT
    assert not _simplex_threads()

    j_raw = JC.run_concurrent(j_generate(384, 384, 5, seed=11, band=64),
                              _settings(JSettings, 1e-8), JTimer())
    assert j_raw["solved_by"] == "pdlp"
    assert j_raw["status"] == raw["status"]
    a, b = raw["primal_objective"], j_raw["primal_objective"]
    assert abs(a - b) <= 1e-6 * abs(b), (a, b)
    # cuopt_tpu leaves its simplex thread to end on its own
    j_seen["thread"].join(timeout=10)
    assert j_seen["saw_halt"] and not j_seen["thread"].is_alive()


def test_race_honours_pdlp_settings(monkeypatch):
    """The PDLP leg honours first_primal_feasible (cuopt_tpu's race runs a
    copy of the major loop that ignores it and three other options)."""
    monkeypatch.setattr(TC, "solve_lp_simplex", _blocked_simplex({}))
    s = _settings(TSettings, 1e-8, first_primal_feasible=True)
    s.tolerances.absolute_primal_tolerance = 1e-4
    s.tolerances.relative_primal_tolerance = 1e-4
    raw = TC.run_concurrent(t_generate(384, 384, 5, seed=11, band=64), s,
                            TTimer(), "cpu")
    assert raw["status"] == C.CUOPT_TERIMINATION_STATUS_PRIMAL_FEASIBLE
    assert raw["solved_by"] == "pdlp"


def test_stop_predicate_ends_the_run():
    """`stop` is checked before the device problem is built (a simplex
    that has already won costs PDLP nothing) and between majors."""
    prob = t_generate(128, 128, 4, seed=1, band=32)
    solver = PdlpSolver(prob, _settings(TSettings), "cpu")
    raw = solver.run(stop=lambda: True)
    assert raw["status"] == C.CUOPT_TERIMINATION_STATUS_CONCURRENT_LIMIT
    assert raw["iterations"] == 0 and "primal_solution" not in raw
    calls = []
    raw = solver.run(stop=lambda: calls.append(1) or len(calls) > 1)
    assert raw["status"] == C.CUOPT_TERIMINATION_STATUS_CONCURRENT_LIMIT
    assert raw["iterations"] == solver.hp.major_iteration


class _FailingPdlp:
    """A PDLP leg that fails as soon as it starts."""

    started = None

    def __init__(self, *args, **kw):
        pass

    def run(self, *args, **kw):
        _FailingPdlp.started.set()
        raise RuntimeError("device leg failed")


def _simplex_after(event, real):
    """A simplex leg that starts only once `event` is set."""
    def stub(*args, **kw):
        assert event.wait(30)
        return real(*args, **kw)
    return stub


def test_pdlp_leg_failure_returns_the_simplex_answer(monkeypatch):
    """The legs are isolated. cuopt_tpu raises here instead and loses the
    simplex's answer (concurrent.py:85-102, VERDICT r05 weak #2): shown
    below with the device problem's build failing in its PDLP leg."""
    started = threading.Event()
    monkeypatch.setattr(_FailingPdlp, "started", started)
    monkeypatch.setattr(TC, "PdlpSolver", _FailingPdlp)
    monkeypatch.setattr(TC, "solve_lp_simplex",
                        _simplex_after(started, solve_lp_simplex))
    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    get_logger().addHandler(handler)
    try:
        sol = t_solve_lp(t_generate(300, 300, 5, seed=11, band=64),
                         _settings(TSettings, time_limit=1.0), device="cpu")
    finally:
        get_logger().removeHandler(handler)
    info = sol.get_additional_termination_information()
    assert sol.get_termination_reason() == "Optimal"
    assert info["solved_by"] == "dual_simplex"
    assert "device leg failed" in info["pdlp_error"]
    assert any("device leg failed" in r.getMessage() for r in records)
    assert not _simplex_threads()

    j_started = threading.Event()

    def failing_build(*args, **kw):
        j_started.set()
        raise RuntimeError("device leg failed")

    monkeypatch.setattr(JP, "build_device_problem", failing_build)
    monkeypatch.setattr(JB, "solve_lp_simplex",
                        _simplex_after(j_started, JB.solve_lp_simplex))
    with pytest.raises(RuntimeError, match="device leg failed"):
        JC.run_concurrent(j_generate(300, 300, 5, seed=11, band=64),
                          _settings(JSettings, time_limit=1.0), JTimer(1.0))


def _failing_simplex(*args, **kw):
    raise ValueError("simplex leg failed")


def test_simplex_leg_failure_returns_pdlp(monkeypatch):
    monkeypatch.setattr(TC, "solve_lp_simplex", _failing_simplex)
    sol = t_solve_lp(t_generate(128, 128, 4, seed=1, band=32),
                     _settings(TSettings), device="cpu")
    info = sol.get_additional_termination_information()
    assert sol.get_termination_reason() == "Optimal"
    assert info["solved_by"] == "pdlp"
    assert "simplex leg failed" in info["race"]["simplex_error"]
    assert "pdlp_error" not in info


def test_both_legs_failing_raises(monkeypatch):
    monkeypatch.setattr(_FailingPdlp, "started", threading.Event())
    monkeypatch.setattr(TC, "PdlpSolver", _FailingPdlp)
    monkeypatch.setattr(TC, "solve_lp_simplex", _failing_simplex)
    with pytest.raises(RuntimeError, match="device leg failed"):
        t_solve_lp(t_generate(128, 128, 4, seed=1, band=32),
                   _settings(TSettings), device="cpu")
    assert not _simplex_threads()


def test_cuda_without_a_card_raises_before_the_race(monkeypatch):
    """The default method is Concurrent: without a card a solve that does
    not ask for the CPU raises, even on an LP the simplex would solve
    at once, and no simplex thread starts."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    legs = []
    monkeypatch.setattr(TC, "_SimplexLeg",
                        lambda *a: legs.append(a) or pytest.fail("raced"))
    s = TSettings()
    s.log_to_console = False
    assert s.method == C.CUOPT_METHOD_CONCURRENT
    assert math.isinf(s.time_limit)
    with pytest.raises(RuntimeError, match="CUDA card"):
        t_solve_lp(t_generate(300, 300, 5, seed=11, band=64), s)
    assert not legs


def test_halt_pointer_reaches_the_library():
    """The race's halt is a ctypes pointer to an int: set beforehand, it
    stops the native simplex at its first poll."""
    halt = ctypes.c_int(1)
    raw = solve_lp_simplex(t_generate(300, 300, 5, seed=11, band=64),
                           _settings(TSettings), TTimer(),
                           halt=ctypes.pointer(halt))
    assert raw["status"] == C.CUOPT_TERIMINATION_STATUS_CONCURRENT_LIMIT
