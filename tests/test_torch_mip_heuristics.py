"""cuopt_torch's MIP heuristics (roundings, LP completion, line-segment
search, the feasibility pump, the population) against cuopt_tpu's, on
the CPU.

The roundings and the line-segment search are numpy in both packages,
and LP completion solves with the same native simplex (built from the
same source), so all of them agree exactly. The pump differs on purpose:
see test_pump_projection_lp_carries_its_iterations_bounds.
"""

import numpy as np
import pytest
import torch

import cuopt_torch.lp.pdlp as TP
from cuopt_torch.mip import feasibility_pump as TF
from cuopt_torch.mip import population as TPop
from cuopt_torch.mip import rounding as TR
from cuopt_torch.problem.data_model import OptimizationProblem as TProb
from cuopt_torch.problem.synthetic import generate_lp as t_generate

pytest.importorskip("jax")
from cuopt_tpu.mip import feasibility_pump as JF  # noqa: E402
from cuopt_tpu.mip import population as JPop  # noqa: E402
from cuopt_tpu.mip import rounding as JR  # noqa: E402
from cuopt_tpu.problem.synthetic import generate_lp as j_generate  # noqa: E402
from torch_mip_instances import staircase_mip  # noqa: E402

torch.set_num_threads(1)


def pump_instance(P):
    """test_mip_solver.py:145's instance: integer rows b +- 0.5."""
    rng = np.random.default_rng(7)
    m, n = 12, 8
    A = rng.integers(-3, 4, (n, m)).astype(float)
    x_true = rng.integers(0, 5, m).astype(float)
    b = A @ x_true
    p = P(
        offsets=np.arange(0, n * m + 1, m),
        indices=np.tile(np.arange(m), n), values=A.ravel(),
        objective_coefficients=np.zeros(m),
        constraint_lower_bounds=b - 0.5, constraint_upper_bounds=b + 0.5,
        variable_lower_bounds=np.zeros(m),
        variable_upper_bounds=np.full(m, 6.0),
        variable_types=np.full(m, "I", "U1"),
        row_types=np.full(n, "E", "U1"), rhs=b)
    return p, A, b, x_true, rng


@pytest.fixture(scope="module")
def mips():
    tp, x_hat = staircase_mip(t_generate, 200, 0, with_point=True)
    return tp, staircase_mip(j_generate, 200, 0), x_hat


def _relax_point(p, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(p.variable_lower_bounds, p.variable_upper_bounds)


def test_roundings_equal(mips):
    tp, jp, x_hat = mips
    x = _relax_point(tp)
    for a, b in zip(TR.make_roundings(tp, x, n_random=5, seed=3),
                    JR.make_roundings(jp, x, n_random=5, seed=3)):
        assert np.array_equal(a, b)
    a = TR.constraint_prop_rounding(tp, x)
    b = JR.constraint_prop_rounding(jp, x)
    assert (a is None) == (b is None)
    if a is not None:
        assert np.array_equal(a, b)
    xr = TR.make_roundings(tp, x, n_random=0)[0]
    a = TR.bounds_repair_rounding(tp, xr)
    b = JR.bounds_repair_rounding(jp, xr)
    assert np.array_equal(a, b)
    assert TR.violation(tp, a) == JR.violation(jp, b)
    assert TR.is_feasible(tp, a) == JR.is_feasible(jp, b)


def test_constraint_prop_and_bounds_repair_roundings():
    """test_mip_solver.py:331 on the port."""
    A = np.array([[1.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    p = TProb.from_dense(
        A, c=np.array([-1.0, -1.0, 0.0]),
        constraint_lower=np.array([-np.inf, -np.inf]),
        constraint_upper=np.array([1.0, 5.0]),
        variable_lower=np.zeros(3), variable_upper=np.array([1.0, 1.0, 5.0]),
        variable_types=np.array(["I", "I", "C"]))
    x = TR.constraint_prop_rounding(p, np.array([0.5, 0.5, 2.5]))
    assert x is not None and TR.violation(p, x) <= 1e-6
    xr = TR.bounds_repair_rounding(p, np.array([1.0, 1.0, 2.5]))
    assert TR.violation(p, xr) <= 1e-6 and xr[0] + xr[1] <= 1 + 1e-9


def test_lp_completion_equal(mips):
    tp, jp, x_hat = mips
    # x_hat's integer pattern has a feasible completion by construction
    ta, tobj = TR.lp_completion(tp, x_hat, device="cpu")
    ja, jobj = JR.lp_completion(jp, x_hat)
    assert ta is not None and ja is not None
    assert np.array_equal(ta, ja) and tobj == jobj
    assert TR.is_feasible(tp, ta) and tobj <= float(
        tp.objective_coefficients @ x_hat) + 1e-9
    # a random pattern: both complete it, or both find its LP infeasible
    x = TR.make_roundings(tp, _relax_point(tp, 1), n_random=0)[0]
    ta, tobj = TR.lp_completion(tp, x, device="cpu")
    ja, jobj = JR.lp_completion(jp, x)
    assert (ta is None) == (ja is None) and tobj == jobj


def test_lp_completion_skips_patterns_no_completion_meets(mips,
                                                         monkeypatch):
    """A rounding whose fixed integers leave some row out of reach of
    every completion gives cuopt_tpu's answer, no completion, without an
    LP: the activity ranges over the box already miss the rows by more
    than is_feasible allows."""
    tp, jp, x_hat = mips
    x = TR.make_roundings(tp, _relax_point(tp, 1), n_random=0)[0]
    is_int = tp.variable_types == "I"
    lv = np.where(is_int, np.round(x), tp.variable_lower_bounds)
    uv = np.where(is_int, lv, tp.variable_upper_bounds)
    assert TR._unreachable(tp, lv, uv) > 1e-6 * tp.n_constraints ** 0.5
    assert JR.lp_completion(jp, x)[0] is None

    def no_lp(*a, **k):
        raise AssertionError("an LP was solved")

    monkeypatch.setattr(TR, "solve_lp_simplex", no_lp)
    monkeypatch.setattr(TR, "PdlpSolver", no_lp)
    assert TR.lp_completion(tp, x, device="cpu") == (None, np.inf)
    # x_hat's pattern is within reach, and its completion is solved
    lv = np.where(is_int, x_hat, tp.variable_lower_bounds)
    uv = np.where(is_int, x_hat, tp.variable_upper_bounds)
    assert TR._unreachable(tp, lv, uv) == 0.0


def test_line_segment_search_equal(mips):
    tp, jp, x_hat = mips
    x_from = _relax_point(tp, 2)
    x_to = TR.make_roundings(tp, _relax_point(tp, 3), n_random=0)[0]
    a = TF.line_segment_search(tp, x_from, x_to)
    b = JF.line_segment_search(jp, x_from, x_to)
    assert a[2] == b[2] and a[1] == b[1]
    if a[2]:
        assert np.array_equal(a[0], b[0])
    # test_mip_solver.py:177 on the port
    p = TProb(
        offsets=np.array([0, 2]), indices=np.array([0, 1]),
        values=np.array([1.0, 1.0]),
        objective_coefficients=np.array([-1.0, -1.0]),
        constraint_lower_bounds=np.array([-np.inf]),
        constraint_upper_bounds=np.array([7.5]),
        variable_lower_bounds=np.zeros(2),
        variable_upper_bounds=np.full(2, 5.0),
        variable_types=np.full(2, "I", "U1"),
        row_types=np.array(["L"], "U1"), rhs=np.array([7.5]))
    x, obj, found = TF.line_segment_search(
        p, np.array([0.0, 0.0]), np.array([3.75, 3.75]))
    assert found and x[0] + x[1] <= 7.5


def test_pump_finds_feasible():
    """test_mip_solver.py:145 on the port."""
    p, A, b, x_true, rng = pump_instance(TProb)
    x0 = np.clip(x_true + rng.uniform(-0.45, 0.45, len(x_true)), 0, 6)
    x, obj, found = TF.feasibility_pump(p, x0, time_budget_s=60.0,
                                        device="cpu")
    assert found
    act = A @ x
    assert np.all(act >= b - 0.5 - 1e-6) and np.all(act <= b + 0.5 + 1e-6)


def test_pump_projection_lp_carries_its_iterations_bounds(monkeypatch):
    """Every projection LP is solved with the distance targets of its own
    iteration. cuopt_tpu's pump moves the bounds of one problem object in
    place while its device problem stays cached on that object under a
    key that leaves the bounds out (cuopt_tpu/lp/pdlp.py:815-827), so
    from its second iteration on it solves the first iteration's LP
    again; the port's cache key holds a digest of the bounds."""
    p, A, b, x_true, rng = pump_instance(TProb)
    seen = []
    build = TP.build_device_problem

    def spy(prob, *a, **k):
        dev = build(prob, *a, **k)
        seen.append((prob.constraint_lower_bounds.copy(),
                     prob.constraint_upper_bounds.copy(),
                     dev.lc_orig.numpy().copy(), dev.uc_orig.numpy().copy()))
        return dev

    monkeypatch.setattr(TP, "build_device_problem", spy)
    x0 = np.random.default_rng(1).uniform(0, 6, len(x_true))
    TF.feasibility_pump(p, x0, time_budget_s=20.0, max_iters=6,
                        device="cpu")
    assert len(seen) >= 2
    for lo, hi, dlo, dhi in seen:
        assert np.array_equal(lo, dlo) and np.array_equal(hi, dhi)
    # the targets really moved between iterations
    assert any(not np.array_equal(seen[0][1], s[1]) for s in seen[1:])


def test_population_add_and_ordering_match(mips):
    tp, jp, x_hat = mips
    tpop = TPop.Population(tp, max_size=4)
    jpop = JPop.Population(jp, max_size=4)
    rng = np.random.default_rng(5)
    xs = []
    for k in range(12):
        x = TR.bounds_repair_rounding(
            tp, TR.make_roundings(tp, _relax_point(tp, 10 + k),
                                  n_random=0)[0])
        xs.append(x)
    xs.append(TR.lp_completion(tp, x_hat, device="cpu")[0])
    xs.append(x_hat)
    xs.append(x_hat.copy())  # a duplicate
    for x in xs + [rng.uniform(0, 1, tp.n_variables)]:
        assert tpop.add(x) == jpop.add(x)
        for (oa, xa), (ob, xb) in zip(tpop.feasible, jpop.feasible):
            assert oa == ob and np.array_equal(xa, xb)
        assert len(tpop.feasible) == len(jpop.feasible)
        assert [v for v, _ in tpop.infeasible] == \
            [v for v, _ in jpop.infeasible]
        tpop.adapt_weight()
        jpop.adapt_weight()
        assert tpop.infeas_weight == jpop.infeas_weight
        for (_, xa), (_, xb) in zip(tpop.infeasible, jpop.infeasible):
            assert np.array_equal(xa, xb)
    assert len(tpop.infeasible) > 0 and len(tpop.feasible) == 2
