"""cuopt_torch's feasibility jump against cuopt_tpu's, on CPU tensors.

The same problems, starts and objective weights go through both packages'
climbers. On all-integer instances with integer data every score is
exact, so the moves, and with them x, best_x and has_feasible, agree bit
for bit; act, w and obj_weight within 1e-12 relative (XLA fuses the
weight bump's multiply-adds). On the mixed staircase MIP the scores differ
in their last bits (XLA contracts and orders the float64 products and
sums in its own way), and where two candidates tie exactly, a last bit
picks the move: from the starts below no such tie is met within 64 steps,
and the states agree within 1e-9.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import cuopt_torch.mip.feasibility_jump as T  # noqa: E402
import cuopt_tpu.mip.feasibility_jump as J  # noqa: E402
from cuopt_torch.problem.data_model import OptimizationProblem as TProb  # noqa: E402
from cuopt_torch.problem.synthetic import generate_lp as t_generate  # noqa: E402
from cuopt_tpu.problem.data_model import OptimizationProblem as JProb  # noqa: E402
from cuopt_tpu.problem.synthetic import generate_lp as j_generate  # noqa: E402
from torch_mip_instances import staircase_mip  # noqa: E402

torch.set_num_threads(1)


def covering(P):
    """test_mip_solver.py:125's instance: min sum x, every row covered."""
    rng = np.random.default_rng(3)
    m, n = 12, 8
    A = (rng.random((n, m)) < 0.4).astype(float)
    A[:, 0] = 1.0
    return P.from_dense(
        A, np.ones(m), np.ones(n), np.full(n, np.inf),
        variable_lower=np.zeros(m), variable_upper=np.ones(m),
        variable_types=np.full(m, "I", "U1"))


def int_knapsacks(P):
    """Two-sided integer rows with small integer coefficients."""
    rng = np.random.default_rng(11)
    m, n = 30, 12
    A = rng.integers(-3, 6, (n, m)).astype(float)
    x_true = rng.integers(0, 4, m).astype(float)
    b = A @ x_true
    return P.from_dense(
        A, -rng.integers(1, 9, m).astype(float), b - 2.0, b + 1.0,
        variable_lower=np.zeros(m), variable_upper=np.full(m, 5.0),
        variable_types=np.full(m, "I", "U1"))


INSTANCES = {
    "covering": (covering(TProb), covering(JProb)),
    "int-knapsacks": (int_knapsacks(TProb), int_knapsacks(JProb)),
    "staircase-mip-200": (staircase_mip(t_generate, 200, 0),
                          staircase_mip(j_generate, 200, 0)),
}


def _starts(prob, k, seed=0):
    rng = np.random.default_rng(seed)
    lv = np.where(np.isfinite(prob.variable_lower_bounds),
                  prob.variable_lower_bounds, -3.0)
    uv = np.where(np.isfinite(prob.variable_upper_bounds),
                  prob.variable_upper_bounds, 3.0)
    return [rng.uniform(lv, uv) for _ in range(k)]


def _jax_batch(p, starts, weights):
    states = [J.init_state(p, x0, i, w)
              for i, (x0, w) in enumerate(zip(starts, weights))]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (np.abs(b) + 1e-12), initial=0.0))


@pytest.mark.parametrize("name", list(INSTANCES))
def test_make_fj_problem_arrays_equal(name):
    tp, jp = INSTANCES[name]
    t, j = T.make_fj_problem(tp, device="cpu"), J.make_fj_problem(jp)
    for f in dataclasses.fields(J.FjProblem):
        a, b = getattr(t, f.name).numpy(), np.asarray(getattr(j, f.name))
        assert a.shape == b.shape, f.name
        assert np.array_equal(a, b), f.name
    # the port's own knobs, at cuopt_tpu's behaviour by default
    assert not t.margin.any() and (t.decay, t.rest) == (0.95, 0.05)


@pytest.mark.parametrize("name,steps", [
    ("covering", 64), ("covering", 256),
    ("int-knapsacks", 64), ("int-knapsacks", 256),
])
def test_chunk_matches_on_integer_instances(name, steps):
    tp, jp = INSTANCES[name]
    weights = [1e-3, 1e-2, 1e-4, 0.0, 1e-3, 1e-2]
    starts = _starts(tp, len(weights))
    t = T.fj_chunk(T.make_fj_problem(tp, device="cpu"),
                   T.init_state(T.make_fj_problem(tp, device="cpu"),
                                np.stack(starts), weights), steps)
    jpb = J.make_fj_problem(jp)
    j = J.fj_chunk(jpb, _jax_batch(jpb, starts, weights), steps)
    for f in ("x", "best_x", "has_feasible"):
        assert np.array_equal(getattr(t, f).numpy(),
                              np.asarray(getattr(j, f))), f
    for f in ("act", "w", "obj_weight"):
        assert _rel(getattr(t, f).numpy(), getattr(j, f)) <= 1e-12, f
    assert np.array_equal(t.steps.numpy(), np.asarray(j.steps))


def test_chunk_matches_on_mixed_instance():
    tp, jp = INSTANCES["staircase-mip-200"]
    weights = [1e-3, 1e-2, 1e-4, 0.0]
    starts = _starts(tp, len(weights), seed=0)
    tpb = T.make_fj_problem(tp, device="cpu")
    t = T.fj_chunk(tpb, T.init_state(tpb, np.stack(starts), weights), 64)
    jpb = J.make_fj_problem(jp)
    j = J.fj_chunk(jpb, _jax_batch(jpb, starts, weights), 64)
    for f in ("x", "best_x", "act", "w", "obj_weight", "best_obj"):
        a, b = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        assert np.allclose(a, b, rtol=1e-9, atol=1e-9), f
    assert np.array_equal(t.has_feasible.numpy(), np.asarray(j.has_feasible))


@pytest.mark.parametrize("name", ["int-knapsacks", "staircase-mip-200"])
def test_blocked_scoring_equals_unblocked(name):
    """Scoring over blocks of variables (a cap of a few kB here) gives
    the same bits as one block over every variable."""
    tp, _ = INSTANCES[name]
    p = T.make_fj_problem(tp, device="cpu")
    s0 = T.init_state(p, np.stack(_starts(tp, 5)), [1e-3] * 5)
    block = T.score_block_size(p, 5, cap_bytes=4096)
    assert 1 <= block < tp.n_variables
    m = tp.n_variables
    whole = T.score_block(p, s0, 0, m)
    parts = [T.score_block(p, s0, j, min(j + block, m))
             for j in range(0, m, block)]
    for k in range(2):
        assert torch.equal(whole[k], torch.cat([q[k] for q in parts], 1))
    a = T.fj_chunk(p, s0, 32, block=m)
    b = T.fj_chunk(p, s0, 32, block=block)
    for f in dataclasses.fields(T.FjState):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def test_engine_step_and_reseed_match():
    """FjEngine from the same starts: the first chunk's pushed incumbent
    and a reseed from it under the engine's own rng give the same
    climbers in both packages."""
    tp, jp = INSTANCES["int-knapsacks"]
    starts = _starts(tp, 4, seed=2)
    te = T.FjEngine(tp, starts, seed=3, device="cpu")
    je = J.FjEngine(jp, starts, seed=3)
    assert te.batch_size == je.batch_size
    tout, jout = te.step(), je.step()
    assert (tout is None) == (jout is None)
    x_inc = tout[0] if tout is not None else starts[0]
    if tout is not None:
        assert np.array_equal(tout[0], np.asarray(jout[0]))
        assert tout[1] == jout[1]
    te.reseed(x_inc)
    je.reseed(x_inc)
    for f in ("x", "best_x", "has_feasible"):
        a = getattr(te.batch, f).numpy()
        assert np.array_equal(a, np.asarray(getattr(je.batch, f))), f
    for f in ("act", "w", "obj_weight"):
        assert _rel(getattr(te.batch, f).numpy(),
                    getattr(je.batch, f)) <= 1e-12, f
    tout, jout = te.step(), je.step()
    assert np.array_equal(te.batch.x.numpy(), np.asarray(je.batch.x))


def test_covering_case_is_found():
    """test_mip_solver.py:125 on the port: FJ covers every row."""
    tp, _ = INSTANCES["covering"]
    x, obj, found = T.run_feasibility_jump(tp, [np.zeros(12)], 0.5,
                                           device="cpu")
    assert found
    A = tp.to_dense()
    assert np.all(A @ x >= 1.0 - 1e-6)
    assert obj == pytest.approx(float(np.sum(x)))


@pytest.mark.parametrize("n,seed", [(300, 4), (400, 5)])
def test_chunk_rescoring_equals_full_rescoring(n, seed):
    """A chunk rescores only the variables each step changed: the same
    bits as rescoring every variable at every step, which chunks of one
    step do."""
    tp = staircase_mip(t_generate, n, 0)
    p = T.make_fj_problem(tp, device="cpu")
    weights = [1e-3, 1e-2, 1e-4, 0.0, 1e-3]
    s0 = T.init_state(p, np.stack(_starts(tp, len(weights), seed=seed)),
                      weights)
    stats = {}
    a = T.fj_chunk(p, s0, 64, stats=stats)
    b = s0
    for _ in range(64):
        b = T.fj_chunk(p, b, 1)
    for f in dataclasses.fields(T.FjState):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
    # both kinds of refresh ran: partial after moves, full after bumps
    assert 0 < stats["full_rescores"] < 64 * len(weights)
