"""cuopt_torch's PDLP warm start and initial solutions against cuopt_tpu's.

Warm-start data is the solver's whole state in its scaled space, with the
field names and dict layout of cuopt_tpu, so data captured by one package
restores in the other. PDLP's iterates are chaotic in the last bits (see
tests/test_torch_pdlp.py): two runs that sum in another order drift apart
about a thousandfold a major. So the continuations compared here are two
majors long, where both packages stay within 1e-9 of each other; a run to
optimality ends at different points of the tolerance ball.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import cuopt_torch.lp.pdlp as T  # noqa: E402
import cuopt_torch.lp.warm_start as TW  # noqa: E402
import cuopt_tpu.lp.pdlp as J  # noqa: E402
from cuopt_torch import constants as C  # noqa: E402
from cuopt_torch.lp.settings import PDLPSolverSettings as TSettings  # noqa: E402
from cuopt_torch.lp.solve import solve_lp as t_solve_lp  # noqa: E402
from cuopt_torch.problem.synthetic import generate_lp as t_generate  # noqa: E402
from cuopt_torch.sparse.reorder import permute_csr  # noqa: E402
from cuopt_tpu.lp.settings import PDLPSolverSettings as JSettings  # noqa: E402
from cuopt_tpu.lp.solve import solve_lp as j_solve_lp  # noqa: E402
from cuopt_tpu.lp.warm_start import PdlpWarmStartData as JData  # noqa: E402
from cuopt_tpu.problem.synthetic import generate_lp as j_generate  # noqa: E402

torch.set_num_threads(1)

MAJOR = 40  # steps per major of the default preset (Stable2)


def _settings(S, tol=1e-4, **kw):
    s = S()
    s.log_to_console = False
    s.method = C.CUOPT_METHOD_PDLP
    s.set_optimality_tolerance(tol)
    for k, v in kw.items():
        setattr(s, k, v)
    return s


def _gap(a, b):
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b), initial=0.0)
                 / max(np.max(np.abs(b), initial=0.0), 1e-300))


def _assert_data_close(t_ws, j_ws, rtol):
    for f in dataclasses.fields(TW.PdlpWarmStartData):
        a, b = getattr(t_ws, f.name), getattr(j_ws, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == np.float64 and a.shape == b.shape, f.name
            assert _gap(a, b) <= rtol, (f.name, _gap(a, b))
        elif isinstance(b, int):
            assert a == b, f.name
        else:
            assert abs(a - b) <= rtol * abs(b), (f.name, a, b)


def _lp(generate):
    return generate(384, 384, 5, seed=11, band=64)


def test_warm_start_from_cuopt_tpu_data_continues_alike():
    j_raw = J.PdlpSolver(_lp(j_generate), _settings(
        JSettings, iteration_limit=2 * MAJOR)).run()
    assert j_raw["status"] == C.CUOPT_TERIMINATION_STATUS_ITERATION_LIMIT
    data = json.loads(json.dumps(j_raw["warm_start_data_fn"]().to_dict()))
    t_out = T.PdlpSolver(_lp(t_generate), _settings(
        TSettings, iteration_limit=4 * MAJOR,
        warm_start_data=TW.PdlpWarmStartData.from_dict(data)), "cpu").run()
    j_out = J.PdlpSolver(_lp(j_generate), _settings(
        JSettings, iteration_limit=4 * MAJOR,
        warm_start_data=JData.from_dict(data))).run()
    assert t_out["status"] == j_out["status"] == \
        C.CUOPT_TERIMINATION_STATUS_ITERATION_LIMIT
    # the counters carry over: two majors restored, two more run
    assert t_out["iterations"] == j_out["iterations"] == 4 * MAJOR
    assert t_out["attempts"] == j_out["attempts"]
    a, b = t_out["primal_objective"], j_out["primal_objective"]
    assert abs(a - b) <= 1e-9 * abs(b), (a, b)
    assert _gap(t_out["primal_solution"], j_out["primal_solution"]) <= 1e-9


def test_capture_matches_cuopt_tpu():
    """Each package captures its own state after the same two majors."""
    t_raw = T.PdlpSolver(_lp(t_generate), _settings(
        TSettings, iteration_limit=2 * MAJOR), "cpu").run()
    j_raw = J.PdlpSolver(_lp(j_generate), _settings(
        JSettings, iteration_limit=2 * MAJOR)).run()
    _assert_data_close(t_raw["warm_start_data_fn"](),
                       j_raw["warm_start_data_fn"](), 1e-9)


def test_restore_round_trips_the_state():
    prob = _lp(t_generate)
    solver = T.PdlpSolver(prob, _settings(TSettings), "cpu")
    dev = T.build_device_problem(prob, solver.hp, torch.float64,
                                 device="cpu")
    state, _ = T.make_major_fn(solver.cfg)(
        dev, T.initial_state(dev, solver.hp, torch.float64))
    data = json.loads(json.dumps(TW.capture_warm_start(dev, state).to_dict()))
    back = TW.restore_state(TW.PdlpWarmStartData.from_dict(data), dev,
                            torch.float64)
    for f in dataclasses.fields(T.SolverState):
        a, b = getattr(back, f.name), getattr(state, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert torch.equal(a, b), f.name


def test_restore_rebases_through_user_space():
    """Data captured under other scaling diagonals restores to the same
    user-space iterates."""
    prob = _lp(t_generate)
    solver = T.PdlpSolver(prob, _settings(TSettings), "cpu")
    dev = T.build_device_problem(prob, solver.hp, torch.float64,
                                 device="cpu")
    state, _ = T.make_major_fn(solver.cfg)(
        dev, T.initial_state(dev, solver.hp, torch.float64))
    ws = TW.capture_warm_start(dev, state)
    rng = np.random.default_rng(0)
    old_r = ws.row_scale * rng.uniform(0.5, 2.0, ws.row_scale.shape)
    old_c = ws.col_scale * rng.uniform(0.5, 2.0, ws.col_scale.shape)
    other = dataclasses.replace(
        ws, row_scale=old_r, col_scale=old_c,
        current_primal_solution=ws.current_primal_solution
        * ws.col_scale / old_c,
        current_dual_solution=ws.current_dual_solution * ws.row_scale / old_r,
        current_AX=ws.current_AX * old_r / ws.row_scale)
    back = TW.restore_state(other, dev, torch.float64)
    for name in ("x", "y", "ax"):
        assert torch.allclose(getattr(back, name), getattr(state, name),
                              rtol=1e-13, atol=1e-15), name


def _shuffled(generate, n=512):
    """A banded LP under a random row and column permutation, which
    operator_kind="bandperm" reorders back into a band."""
    prob = generate(n, n, 6, seed=5, band=96)
    rng = np.random.default_rng(9)
    rp, cp = rng.permutation(n), rng.permutation(n)
    off, idx, val = permute_csr(prob.offsets, prob.indices,
                                np.asarray(prob.values, np.float64),
                                rp, cp, n, n)
    return dataclasses.replace(
        prob, offsets=off, indices=idx, values=val,
        constraint_lower_bounds=prob.constraint_lower_bounds[rp],
        constraint_upper_bounds=prob.constraint_upper_bounds[rp],
        objective_coefficients=prob.objective_coefficients[cp],
        variable_lower_bounds=prob.variable_lower_bounds[cp],
        variable_upper_bounds=prob.variable_upper_bounds[cp],
        variable_names=[], row_names=[])


_KINDS = {"plain": (_lp, "auto"), "bandperm": (_shuffled, "bandperm")}


@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_initial_solutions_match(kind):
    """initial_primal_solution / initial_dual_solution, in user space:
    the same initial state in both packages (on a bandperm operator, the
    points are permuted into the operator's order), and end to end the
    same status and objective (1e-6 at 1e-8, tests/test_torch_pdlp.py)."""
    make, op_kind = _KINDS[kind]
    t_prob, j_prob = make(t_generate), make(j_generate)
    rng = np.random.default_rng(1)
    x0 = rng.uniform(0.0, 1.0, t_prob.n_variables)
    y0 = rng.standard_normal(t_prob.n_constraints)
    hp = J.PRESETS[C.CUOPT_PDLP_SOLVER_MODE_STABLE2]
    j_dev = J.build_device_problem(j_prob, hp, jnp.float64, op_kind)
    t_dev = T.build_device_problem(t_prob, hp, torch.float64, op_kind, "cpu")
    assert (t_dev.col_perm is not None) == (kind == "bandperm")
    assert (j_dev.col_perm is not None) == (kind == "bandperm")
    j_state = J.initial_state(j_dev, hp, jnp.float64, x0, y0)
    t_state = T.initial_state(t_dev, hp, torch.float64, x0, y0)
    for name in ("x", "y", "ax", "aty", "step_size", "primal_weight"):
        assert _gap(getattr(t_state, name), getattr(j_state, name)) <= \
            1e-12, name
    sols = [solve(make(gen), _settings(
        S, 1e-8, operator_kind=op_kind, iteration_limit=20000,
        initial_primal_solution=x0, initial_dual_solution=y0), **kw)
        for S, solve, gen, kw in (
            (TSettings, t_solve_lp, t_generate, dict(device="cpu")),
            (JSettings, j_solve_lp, j_generate, {}))]
    assert sols[0].get_termination_reason() == \
        sols[1].get_termination_reason() == "Optimal"
    a, b = sols[0].get_primal_objective(), sols[1].get_primal_objective()
    assert abs(a - b) <= 1e-6 * abs(b), (a, b)


def test_warm_start_data_is_lazy(monkeypatch):
    captured = []
    real = TW.capture_warm_start

    def counting(*args):
        captured.append(1)
        return real(*args)

    monkeypatch.setattr(TW, "capture_warm_start", counting)
    sol = t_solve_lp(_lp(t_generate), _settings(TSettings), device="cpu")
    assert "warm_start_data" not in sol._raw and not captured
    ws = sol.get_pdlp_warm_start_data()
    assert isinstance(ws, TW.PdlpWarmStartData) and len(captured) == 1
    assert sol.get_pdlp_warm_start_data() is ws and len(captured) == 1
    assert ws.total_pdlp_iterations == sol.get_nb_iterations()


def test_warm_resolve_after_an_objective_change():
    """The re-solve of the chip smoke's warm-start phase, at a small size
    in float64: the objective scaled by 1 + 1e-3 (the scaling depends only
    on A), re-solved warm and cold to the same optimum, warm in fewer new
    steps."""
    prob = _lp(t_generate)
    first = t_solve_lp(prob, _settings(TSettings), device="cpu")
    ws = first.get_pdlp_warm_start_data()
    moved = dataclasses.replace(
        prob, objective_coefficients=prob.objective_coefficients * 1.001)
    warm = t_solve_lp(moved, _settings(TSettings, warm_start_data=ws),
                      device="cpu")
    cold = t_solve_lp(moved, _settings(TSettings), device="cpu")
    assert warm.get_termination_reason() == cold.get_termination_reason() \
        == "Optimal"
    a, b = warm.get_primal_objective(), cold.get_primal_objective()
    assert abs(a - b) <= 1e-4 * abs(b), (a, b)
    warm_steps = warm.get_nb_iterations() - ws.total_pdlp_iterations
    assert 0 < warm_steps < cold.get_nb_iterations()
